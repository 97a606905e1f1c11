"""The plain reference against the port at a tiny size on the CPU, the
control and the faults that the comparison must fail, and (on a card) the
TF32 control at a small size."""
import time

import pytest
import torch

import pb_small
from portbench import check, harness
from portbench.reference.pq_transformer import STAGE_A_INPUTS

SMALL = pb_small.SMALL


def small_cell(workload, **over):
    cell = harness.find_cell(harness.load_spec(), workload)
    cell.cfg = {**cell.cfg, **SMALL, **over}
    cell.traffic = {**cell.traffic, "num_points": SMALL["num_points"]}
    return cell


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_matches_the_port(dtype):
    from omni_pq_torch import infer
    from omni_pq_torch.config import ModelConfig
    cell = small_cell("eval_b16.bf16", compute_dtype=dtype)
    pq = cell.model
    sd = pq.check.state_dict(cell.cfg, 5, "cpu")
    prog = infer.load_model(
        sd, ModelConfig(**pq.program.model_fields(cell.cfg)), "cpu")
    pool = harness.make_pool(dict(cell.traffic, batch=2, pool=1), 5, "cpu")
    pc = pool[0]["point_clouds"]
    out = infer.eval_forward(prog, pc)
    ref = pq.check.reference_model(cell.cfg, 5, "cpu")
    with torch.no_grad():
        a = ref.forward_stage_a(pc)
        b = ref.forward_heads({k: a[k] for k in STAGE_A_INPUTS})
    assert set(out) == set(a) | set(b)
    for k, v in {**a, **b}.items():
        torch.testing.assert_close(out[k], v, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("workload", ["semi_3p3.bf16", "sup_b3.f32fused"])
def test_first_train_steps_match_the_port(workload):
    cell = small_cell(workload, compute_dtype="float32")
    pool = harness.make_pool(cell.traffic, 9, "cpu")
    prog = harness.Program(cell, 9, "cpu", pool)
    got = prog.first_steps()
    ref = cell.model.check
    want = ref.reference_readings(cell.cfg, cell.traffic, 9, "cpu",
                                  pool[:harness.CHECK_STEPS])
    numbers = ref.judge_train(got, want)
    assert numbers["first_loss_gap"] < 1e-6
    assert numbers["first_vote_loss_gap"] < 1e-6
    assert numbers["loss_gap"] < 1e-3
    assert numbers["grad_gap"] < 1e-4
    assert numbers["first_change_gap"] < 1e-3
    assert numbers["draws_mismatch"] == 0


def test_fp8_control_fails_the_bf16_eval_limits():
    cell = small_cell("eval_b16.bf16")
    pool = harness.make_pool(dict(cell.traffic, batch=2, pool=1), 3, "cpu")
    numbers = cell.model.check.control_eval(cell.cfg, 3, "cpu",
                                            pool[0]["point_clouds"])
    assert any(numbers[k] > limit for k, limit in cell.limits.items())


def test_fp8_control_fails_the_bf16_train_limits():
    cell = small_cell("semi_3p3.bf16")
    pool = harness.make_pool(cell.traffic, 3, "cpu")
    ref = cell.model.check
    want = ref.reference_readings(cell.cfg, cell.traffic, 3, "cpu",
                                  pool[:harness.CHECK_STEPS])
    got = ref.reference_readings(cell.cfg, cell.traffic, 3, "cpu",
                                 pool[:harness.CHECK_STEPS], low=True)
    numbers = ref.judge_train(got, want)
    assert any(numbers[k] > limit for k, limit in cell.limits.items())


# --- faults planted in the timed path: `correct` must come out false -------

def altered_answer(eval_forward, model, pc):
    """One room's final boxes replaced by another room's."""
    out = dict(eval_forward(model, pc))
    out["last_center"] = out["last_center"].clone()
    out["last_center"][1] = out["last_center"][0]
    return out


def half_batch_eval(eval_forward, model, pc):
    half = eval_forward(model, pc[: pc.shape[0] // 2])
    return {k: torch.cat([v, v]) if v.dim() else v for k, v in half.items()}


def unchanged_state(step, state, labeled, weak, gen, cw):
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    stats = step(state, labeled, weak, gen, cw)
    state.model.load_state_dict(saved)
    if state.ema_model is not None:
        state.ema_model.load_state_dict(saved)
    return stats


def half_batch_train(step, state, labeled, weak, gen, cw):
    return step(state, check.half(labeled), check.half(weak), gen, cw)


CASES = [("eval_b16.bf16", None), ("eval_b16.bf16", altered_answer),
         ("eval_b16.f32fused", half_batch_eval),
         ("sup_b3.f32fused", None), ("sup_b3.f32fused", unchanged_state),
         ("semi_3p3.bf16", unchanged_state),
         ("semi_3p3.bf16", half_batch_train),
         ("sup_b3.f32fused", half_batch_train)]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__ if f else 'sound'}"
                              for w, f in CASES])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    r = harness.run_cell(workload, pb_small.SEED, 0.2, False,
                         time.perf_counter(),
                         device="cpu", cfg_override=SMALL, fault=fault)
    assert r["correct"] is (fault is None), r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["eval_b16.f32fused", "sup_b3.f32fused"])
def test_tf32_control_fails_on_a_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA card")
    cell = small_cell(workload, hidden_dim=288, dim_feedforward=2048, nhead=8)
    pool = harness.make_pool(dict(cell.traffic, batch=2), 3, "cuda")
    ref = cell.model.check
    if cell.traffic["kind"] == "eval":
        numbers = ref.control_eval(cell.cfg, 3, "cuda",
                                   pool[0]["point_clouds"])
    else:
        batches = pool[:harness.CHECK_STEPS]
        want = ref.reference_readings(cell.cfg, cell.traffic, 3, "cuda",
                                      batches)
        got = ref.reference_readings(cell.cfg, cell.traffic, 3, "cuda",
                                     batches, low=True)
        numbers = ref.judge_train(got, want)
    assert any(numbers[k] > limit for k, limit in cell.limits.items())
