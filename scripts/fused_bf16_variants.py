#!/usr/bin/env python3
"""Where the bfloat16 fused SA-MLP kernels' time goes: each call's device
time with one part of the kernels taken out.

Builds copies of `omni_pq_torch/csrc/fused_mlp_bf16.cu` with text
substitutions (one nvcc per variant, all started together, into
build/variants/), then times `ops.fused_mlp.kernel_mlp_pool(...,
dtype=bfloat16)` through each variant's library in turns (the variants in
order, then in reverse) on the bf16 forward's four eval calls (B=16) and
the four train-mode calls of one model at the semi-supervised step's B=6
(sa1-sa4 widths, seeded random inputs). A variant that takes a part out
computes wrong values: it only says what that part costs.

- base: the kernels as they are;
- noepi: no BN + ReLU (the eval chain's epilogue, the pass kernel's A
  transform) - the bfloat16 pair passes through;
- now: no weight copies (the full barrier expects no bytes; the products
  read stale shared memory) - the cost of streaming the weights from L2;
- noa: no activation copies (the cp.async chunks of the float32 rows or
  bfloat16 a_j) - the cost of the A operand's stream;
- nomma: no wgmma (fences, commits and waits stay) - everything but the
  products.

Device time is torch.profiler's, summed over the call's kernels (the eval
chain; a train call's passes, stats and pool launches), a mean over 5
calls. Run on a CUDA card from the root of a checkout:

    python3 scripts/fused_bf16_variants.py [VARIANT ...] [--out FILE]

Prints one line a turn and, last, one JSON line (also written to --out).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBS = {
    "base": [],
    "noepi": [("                                                   float2 "
               "mul, float2 b) {\n  const float y0",
               "                                                   float2 "
               "mul, float2 b) {\n  return af;\n  const float y0")],
    "now": [("    mbar_arrive_expect(full, wbytes);\n    bulk_copy(dst + "
             "stage_a_bytes, w, wbytes, full);",
             "    mbar_arrive_expect(full, 0u);")],
    "noa": [("  if (a) {\n    if (f32 && wl::tile_contiguous(cin)) {",
             "  if (false) {\n    if (f32 && wl::tile_contiguous(cin)) {")],
    "nomma": [("      wgmma_rs_n256(acc, fr + 4 * s, d);", "      ;"),
              ("      wgmma_rs_n128(acc, fr + 4 * s, d);", "      ;")],
}
# (name, centres a scene, K, widths) of the model's four SA layers
SHAPES = [("sa1", 2048, 64, [3, 128, 128, 256]),
          ("sa2", 1024, 32, [259, 256, 256, 512]),
          ("sa3", 512, 16, [515, 256, 256, 512]),
          ("sa4", 256, 16, [515, 256, 256, 512])]
KERNELS = r"::(fused_mlp_bf16|mlp_pass_bf16|mlp_stats|mlp_pool)_kernel\b"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(SUBS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("torch sees no CUDA card", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from omni_pq_torch.ops import cuda, fused_mlp as fm
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    src = open(cuda.CSRC / "fused_mlp_bf16.cu").read()
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in args.variants:
        text = src
        for old, new in SUBS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"variant {name} failed to build:\n{log}", file=sys.stderr)
            return 1
    cuda.library("fused_mlp")  # the stats and pool launches
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def inputs(B, S, K, chans):
        ws = [rnd(a, b) / a ** 0.5 for a, b in zip(chans[:-1], chans[1:])]
        pos = [torch.rand(c, generator=gen, device=dev) + 0.5
               for c in chans[1:]]
        return (rnd(B, S, K, chans[0]), ws, pos,
                [0.1 * rnd(c) for c in chans[1:]],
                [0.2 * rnd(c) for c in chans[1:]],
                [torch.rand(c, generator=gen, device=dev) + 0.5
                 for c in chans[1:]])
    calls = ([(f"{n} eval", inputs(16, S, K, c), False)
              for n, S, K, c in SHAPES]
             + [(f"{n} train", inputs(6, S, K, c), True)
                for n, S, K, c in SHAPES])

    def device_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and re.search(KERNELS, e.key)) / 1e3 / n

    name_fn, argtypes = cuda._SIGNATURES["fused_mlp_bf16"]
    turns = []
    for name in args.variants + args.variants[::-1]:
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        fn = getattr(lib, name_fn)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        for more, types in cuda._MORE_SIGNATURES["fused_mlp_bf16"].items():
            getattr(lib, more).argtypes = types
            getattr(lib, more).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        cuda._loaded["fused_mlp_bf16"] = (fn, lib.error_string, lib)
        ms = {}
        for call, fargs, train in calls:
            with torch.no_grad():
                ms[call] = device_ms(lambda: fm.kernel_mlp_pool(
                    *fargs, train, 1e-5, torch.bfloat16))
        eval_ms = sum(v for k, v in ms.items() if k.endswith("eval"))
        train_ms = sum(v for k, v in ms.items() if k.endswith("train"))
        turns.append(dict(variant=name, ms=ms, eval_ms=eval_ms,
                          train_ms=train_ms))
        print(f"{name:6s} " + " ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f" | eval {eval_ms:.4f} train {train_ms:.4f} ms  [{card}]",
              flush=True)
    line = json.dumps(dict(card=card, turns=turns))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
