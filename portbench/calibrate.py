"""The readings the limits of a cell are set from (not part of a run).

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 ... \
        --control-seeds 1 2 3 [--seconds 2] [--out FILE]

For each of `--seeds`, one run of the program as `run.py` makes it (set-up,
a short window of `--seconds` at the cell's own load, the check against the
reference) and every number the comparison computes, whether the cell's
limits file names it or not: the lower readings. For each of
`--control-seeds`, the same numbers for the control, the reference in the
precision below the configuration's put in the program's place, and, for a
train cell, for the fault "half of the batch left out" planted in the
reference put in its place: the upper readings. For each of
`--witness-seeds` (train cells), the look at what parts two sound runs
after the first step: the program against itself and the reference
against itself (the same seed twice in one process), the reference
against the reference in float64, the program against that, and, after
the first step alone, the share of parameters whose update differs in sign
between each pair and each side's supervised loss terms. One JSON line a
reading on standard output (and appended to `--out`).

Every reading goes through the cell's model (`harness.find_model`): the
program's `System`, and the check's `control_eval`, `reference_readings`,
`judge_train` and `reference_first_update`.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
sys.path[:] = [str(ROOT)] + [q for q in sys.path
                             if Path(q or ".").resolve() != HERE]


def program_numbers(cell, seed, seconds, device):
    from portbench import harness
    m = harness.measure(cell, seed, seconds, False, time.perf_counter(),
                        device)
    win = m["window"]
    return m["numbers"], {"setup_s": m["setup_s"], "calls": win.calls,
                          "seconds": win.seconds,
                          "peak_bytes": win.peak_bytes}


def upper_numbers(cell, seed, device, what):
    from portbench import check, harness
    ref = cell.model.check  # the model's weights and comparison
    pool = harness.make_pool(cell.traffic, seed, device)
    if cell.traffic["kind"] == "eval":
        return ref.control_eval(cell.cfg, seed, device,
                                  pool[0]["point_clouds"])
    batches = [pool[k % len(pool)] for k in range(harness.CHECK_STEPS)]
    with check.tf32(False):
        want = ref.reference_readings(cell.cfg, cell.traffic, seed, device,
                                        batches)
        got = ref.reference_readings(
            cell.cfg, cell.traffic, seed, device, batches,
            low=what == "control", fault="half" if what == "half" else None)
    return ref.judge_train(got, want)


def witness(cell, seed, device):
    """Readings of sound runs against each other (see the docstring)."""
    import torch
    from portbench import check, harness
    ref = cell.model.check  # the model's weights and comparison
    pool = harness.make_pool(cell.traffic, seed, device)
    batches = [pool[k % len(pool)] for k in range(harness.CHECK_STEPS)]
    runs, updates, parts = {}, {}, {}
    for name in ("program", "program_again"):
        prog = harness.Program(cell, seed, device, pool)
        initial = {k: v.clone() for k, v in prog.system.initial.items()}
        stats = prog.call()
        parts[name] = prog.system.parts(stats)
        updates[name] = check.first_update(
            dict(prog.system.model.named_parameters()), initial)
        prog.free()
        prog = harness.Program(cell, seed, device, pool)
        runs[name] = prog.first_steps()
        prog.free()
        del prog
    with check.tf32(False):
        for name, f64 in (("reference", False), ("reference_again", False),
                          ("float64", True)):
            runs[name] = ref.reference_readings(
                cell.cfg, cell.traffic, seed, device, batches, float64=f64)
            updates[name], parts[name] = ref.reference_first_update(
                cell.cfg, cell.traffic, seed, device, batches[0], f64)
    out = []
    for got, want in (("program", "reference"),
                      ("program_again", "program"),
                      ("reference_again", "reference"),
                      ("reference", "float64"), ("program", "float64")):
        a, b = updates[got], updates[want]
        flips = float(((a.sign() != b.sign()) & (b != 0)).double().mean())
        rel = float(torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(b))
        out.append({"what": f"{got} vs {want}", "seed": seed,
                    "numbers": ref.judge_train(runs[got], runs[want]),
                    "first_update_sign_flips": flips,
                    "first_update_rel_gap": rel,
                    "first_step_parts": [parts[got], parts[want]],
                    "losses": [runs[got]["losses"], runs[want]["losses"]]})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    from portbench import harness
    cell = harness.find_cell(harness.load_spec(), args.workload)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.cfg["tf32"])
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")

    def emit(rec):
        rec.update(workload=args.workload, device=name)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in args.seeds:
        numbers, info = program_numbers(cell, seed, args.seconds, args.device)
        emit({"what": "program", "seed": seed, "numbers": numbers, **info})
    whats = ["control"] + (["half"] if cell.traffic["kind"] == "train"
                           else [])
    for seed in args.control_seeds:
        for what in whats:
            emit({"what": what, "seed": seed,
                  "numbers": upper_numbers(cell, seed, args.device, what)})
    for seed in args.witness_seeds:
        for rec in witness(cell, seed, args.device):
            emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
