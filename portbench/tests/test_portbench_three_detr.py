"""3DETR-m in the benchmark on the CPU: `find_model` finds its files by the
configuration's `model`, a tiny eval cell of it runs `correct` and a
perturbed output is not, its counts at the cell's configuration against
shapes worked by hand, and its metrics' readers on those counts and on the
program's spans."""
import time
import types

import pb_small
import pytest
from portbench import harness

CELL = "eval_b16.3detr_m_f32fused"
# the published widths on small rooms: 2048 points, 64 -> 32 tokens, 16
# queries (the cell's 16 rooms a batch)
TINY = dict(num_points=2048, preenc_npoints=64, num_queries=16)


def cell():
    return harness.find_cell(harness.load_spec(), CELL)


def test_the_cell_finds_three_detr_m():
    c = cell()
    assert c.model.name == "three_detr_m"
    assert c.model.program.KINDS == ("eval",)
    assert c.cfg["tf32"] is False and c.cfg["fused_sa"] is True
    assert c.traffic["batch"] == 16 and c.traffic["kind"] == "eval"
    assert set(c.limits) == {"index_mismatch", "stage_a_gap", "stage_b_gap"}
    assert [m["name"] for m in c.per_layer][-2:] == [
        "radius_attention_roofline.eval", "decoder_host_ms.eval"]


@pytest.mark.parametrize("key,value", [("compute_dtype", "bfloat16"),
                                       ("num_angle_bin", 12),
                                       ("dec_dim", 128)])
def test_a_value_the_port_does_not_hold_is_refused(key, value):
    """The keys the port holds at one value are no ThreeDETRConfig fields:
    the configuration must name that value, or the model is not built."""
    c = cell()
    fields = c.model.program.model_fields(c.cfg)
    assert key not in fields and "enc_dim" in fields
    with pytest.raises(ValueError, match=key):
        c.model.program.model_fields({**c.cfg, key: value})


def test_a_tiny_cell_runs_correct_and_a_perturbed_one_does_not():
    r = harness.run_cell(CELL, pb_small.SEED, 0.3, False, time.perf_counter(),
                         device="cpu", cfg_override=TINY)
    assert r["correct"] and r["attempted"] >= 1, r["checks"]
    assert r["checks"]["index_mismatch"]["value"] == 0
    # peak_mem_gib reads the card's allocator: nothing on the CPU
    assert set(r["metrics"]) == {"eval_scenes_per_s", "eval_batch_p95_ms",
                                 "setup_s"}

    def perturbed(forward, model, pc):
        out = dict(forward(model, pc))
        out["last_sem_cls_logits"] = (out["last_sem_cls_logits"] + 1e-3
                                      * out["last_sem_cls_logits"].abs().max())
        return out

    r = harness.run_cell(CELL, pb_small.SEED, 0.3, False, time.perf_counter(),
                         device="cpu", cfg_override=TINY, fault=perturbed)
    assert not r["correct"]
    assert (r["checks"]["stage_b_gap"]["value"]
            > r["checks"]["stage_b_gap"]["limit"])


def test_counts_by_hand():
    """The cell's configuration at B=16: the SA chains, the encoder with
    attention over all pairs, the projection, the Fourier and query
    embeddings, the decoder and the heads; the three FPS and two ball
    queries; the fused interim layer; the attention's bytes."""
    c = cell()
    counts, cfg = c.model.counts, c.cfg
    B, d = 16, 256
    sa = (2 * B * 2048 * 64 * (3 * 64 + 64 * 128 + 128 * d)
          + 2 * B * 1024 * 32 * (259 * d + d * d + d * d))
    enc = 0
    for N in (2048, 1024, 1024):
        enc += (2 * B * N * d * 3 * d + 2 * 2 * B * N * N * d
                + 2 * B * N * d * d + 2 * B * N * (d * 128 + 128 * d))
    mid = (2 * B * 1024 * 2 * d * d + 2 * B * (256 + 1024) * 3 * 128
           + 2 * B * 256 * 2 * d * d)
    dec = 8 * (2 * B * 256 * d * 3 * d + 2 * 2 * B * 256 * 256 * d
               + 2 * B * 256 * d * d
               + 2 * B * 256 * d * d + 2 * 2 * B * 1024 * d * d
               + 2 * 2 * B * 256 * 1024 * d + 2 * B * 256 * d * d
               + 2 * B * 256 * 2 * d * d)
    heads = 8 * sum(2 * B * 256 * (2 * d * d + d * n)
                    for n in (19, 3, 3, 1, 1))
    flops = counts.forward_flops(cfg, B)
    assert flops == sa + enc + mid + dec + heads
    assert 42e9 < flops / B < 44e9  # 42.9 GFLOP a room
    fps = sum(max(B * (S - 1) * N * 10 / 67e12,
                  (B * N * 12 + B * S * 4) / 3.35e12)
              for N, S in ((40000, 2048), (2048, 1024), (1024, 256)))
    bq = sum((B * N * 12 + B * S * 12 + B * S * K * 16) / 3.35e12
             for N, S, K in ((40000, 2048, 64), (2048, 1024, 32)))
    assert counts.point_kernels_bound_s(cfg, B) == pytest.approx(fps + bq,
                                                                 rel=1e-12)
    rows = B * 1024 * 32
    fused = max(4 * (rows * 259 + 259 * d + 2 * d * d + B * 1024 * d)
                / 3.35e12, 2 * rows * (259 * d + 2 * d * d) / 67e12)
    assert counts.fused_mlp_bound_s(cfg, B, False) == pytest.approx(
        fused, rel=1e-12)
    attn = sum(4 * B * N * (3 * d + 3 + d) / 3.35e12
               for N in (2048, 1024, 1024))
    assert counts.radius_attention_bound_s(cfg, B) == pytest.approx(
        attn, rel=1e-12)
    assert abs(attn * 1e3 - 0.0804) < 1e-4  # 134.6 + 2 x 67.3 MB
    assert counts.fused_mlp_bound_s({**cfg, "fused_sa": False}, B,
                                    False) is None

    trace = types.SimpleNamespace(calls=4, kernel_s=lambda pattern: 1e-2,
                                  busy_s=0.75, window_s=1.0, launches=40)
    ctx = harness.Context(cell=c, window=harness.Window(calls=5,
                                                        seconds=2.0),
                          setup_s=1.0, trace=trace)
    read = {m["name"]: harness.load_reader(m["name"])(ctx)
            for m in c.per_layer}
    assert read["mfu.eval"] == pytest.approx(
        100 * flops * 5 / (2.0 * 67e12), rel=1e-12)
    assert read["point_kernels_roofline.eval"] == pytest.approx(
        100 * 4 * (fps + bq) / 1e-2, rel=1e-12)
    assert read["fused_mlp_roofline.eval"] == pytest.approx(
        100 * 4 * fused / 1e-2, rel=1e-12)
    assert read["radius_attention_roofline.eval"] == pytest.approx(
        100 * 4 * attn / 1e-2, rel=1e-12)
    assert read["device_idle_share.eval"] == pytest.approx(25.0)
    assert read["launches_per_batch.eval"] == 10.0


def test_radius_roofline_reads_nothing_for_another_model():
    """The PQ-Transformer's counts have no radius-attention bound."""
    c = harness.find_cell(harness.load_spec(), "eval_b16.f32fused")
    trace = types.SimpleNamespace(calls=4, kernel_s=lambda pattern: 1e-2)
    ctx = harness.Context(cell=c, window=harness.Window(calls=5,
                                                        seconds=2.0),
                          setup_s=1.0, trace=trace)
    assert harness.load_reader("radius_attention_roofline.eval")(ctx) is None


def test_decoder_host_ms_reads_the_spans_of_a_traced_window():
    """The forward's spans, recorded under a CPU profiler: the decoder's
    and the heads' host ms over the `eval.forward` spans."""
    from omni_pq_torch import infer
    from omni_pq_torch.config import ThreeDETRConfig
    from omni_pq_torch.utils import trace
    from torch.profiler import profile
    c = cell()
    model = infer.build_model(ThreeDETRConfig(**{
        **c.model.program.model_fields(c.cfg), **TINY}), device="cpu")
    pc = harness.make_pool({**c.traffic, "num_points": TINY["num_points"],
                            "batch": 2}, 3, "cpu")[0]["point_clouds"]
    trace.clear()
    with profile():
        for _ in range(2):
            infer.eval_forward(model, pc)
    recs = trace.records()
    names = {r.name for r in recs}
    assert {"model.pre_encoder", "model.encoder", "encoder.radius_attention",
            "encoder.ffn", "encoder.downsample", "model.queries",
            "model.decoder", "decoder.self_attention",
            "decoder.cross_attention", "decoder.ffn", "model.heads",
            "eval.forward"} <= names
    assert sum(r.name == "encoder.radius_attention" for r in recs) == 2 * 3
    want = sum(r.t1_ns - r.t0_ns for r in recs
               if r.name in ("model.decoder", "model.heads")) / (2 * 1e6)
    ctx = harness.Context(cell=c, window=harness.Window(), setup_s=1.0,
                          trace=types.SimpleNamespace(calls=2))
    assert harness.load_reader("decoder_host_ms.eval")(ctx) == pytest.approx(
        want, rel=1e-12)
    trace.clear()
    assert harness.load_reader("decoder_host_ms.eval")(ctx) is None
