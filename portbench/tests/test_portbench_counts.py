"""The benchmark's counts against shapes worked by hand."""

import pb_small  # noqa: F401 (puts the checkout on the path)
from portbench.counts import layers, pq_transformer
from portbench.harness import find_cell, load_spec


def full_cfg():
    return find_cell(load_spec(), "eval_b16.f32fused").cfg


def test_chain_flops_at_sa1_widths():
    # sa1: 2048 centres x 64 samples a room, 3 -> 128 -> 128 -> 256
    rows = 16 * 2048 * 64
    want = 2 * rows * (3 * 128 + 128 * 128 + 128 * 256)
    assert layers.chain_flops(rows, [3, 128, 128, 256]) == want


def test_sa_layer_shapes():
    got = pq_transformer.sa_layers(full_cfg())
    assert [(n, N, S, K, c) for n, N, S, K, _, c in got] == [
        ("sa1", 40000, 2048, 64, [3, 128, 128, 256]),
        ("sa2", 2048, 1024, 32, [259, 256, 256, 512]),
        ("sa3", 1024, 512, 16, [515, 256, 256, 512]),
        ("sa4", 512, 256, 16, [515, 256, 256, 512]),
        ("vote_aggregation", 1024, 256, 16, [291, 288, 288, 288])]


def test_fps_bound():
    # 10 operations a point and step at 67 TFLOP/s (sa1 alone 0.1955 ms at
    # B=16): sa1-sa4, the quad queries and the vote aggregation
    calls = [(40000, 2048), (2048, 1024), (1024, 512), (512, 256),
             (1024, 256), (1024, 256)]
    assert [c[1:] for c in pq_transformer.fps_calls(full_cfg())] == calls
    want = sum(max(16 * (S - 1) * N * 10 / 67e12,
                   (16 * N * 12 + 16 * S * 4) / 3.35e12) for N, S in calls)
    assert abs(pq_transformer.fps_bound_s(full_cfg(), 16) - want) < 1e-15
    assert abs(16 * 2047 * 40000 * 10 / 67e12 * 1e3 - 0.1955) < 1e-4


def test_fused_layers_and_bound():
    cfg = full_cfg()
    assert [n for n, *_ in pq_transformer.fused_layers(cfg)] == [
        "sa1", "sa2", "sa3", "sa4"]
    # one chain a layer, operations-bound: 9.143 ms at B=16 (PERF.md)
    bound = pq_transformer.fused_mlp_bound_s
    assert abs(bound(cfg, 16, False) * 1e3 - 9.1433) < 1e-3
    assert abs(bound(cfg, 3, True) * 1e3 - 1.7144) < 1e-3


def test_no_fused_bound_without_fused_sa():
    """The bf16 configuration runs no fused SA: its fused roofline reads
    nothing."""
    cfg = find_cell(load_spec(), "eval_b16.bf16").cfg
    assert not cfg["fused_sa"]
    assert pq_transformer.fused_mlp_bound_s(cfg, 16, False) is None


def test_model_flops():
    cfg = full_cfg()
    f1 = pq_transformer.forward_flops(cfg, 1)
    assert pq_transformer.forward_flops(cfg, 16) == 16 * f1
    # the backbone's SA chains alone, by hand
    sa = sum(layers.chain_flops(S * K, c)
             for _, _, S, K, _, c in pq_transformer.sa_layers(cfg))
    assert 0.5 * f1 < sa < f1
    assert 60e9 < f1 < 70e9
    assert pq_transformer.step_flops(cfg, 6, True) == 4 * 6 * f1
    assert pq_transformer.step_flops(cfg, 3, False) == 3 * 3 * f1
