"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (`omni_pq_torch`). Prints
one JSON line (the last line of standard output) and, as the last lines of
standard error, each number the comparison with the reference compared,
beside its limit (before them, those it read and did not compare). Exits
with a code other than 0, printing no result, without a CUDA card (or with
fewer cards than the cell asks for), and if JAX or the JAX package is
loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths (the
# port builds its CUDA libraries into build/omni_pq_torch/ itself)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
os.environ["USE_FLAX"] = "0"
# import the benchmark as the package `portbench`, never its files as
# top-level modules
HERE = Path(__file__).resolve().parent
sys.path[:] = [str(ROOT)] + [q for q in sys.path
                             if Path(q or ".").resolve() != HERE]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from portbench import harness
    cell = harness.find_cell(harness.load_spec(), args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    from portbench.clocks import gpu_name_power
    print(f"card: {gpu_name_power()}", file=sys.stderr)
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
