#!/usr/bin/env bash
# Protocol-B runs of the port sharing one card: each ARM:SEED is a process
# of its own of `python -m omni_pq_torch.experiments.semi_sup_ab` (AB_ARMS,
# AB_SEEDS and AB_OUT set for it), its log, JSON and report under OUT_DIR.
#
#   scripts/semi_sup_ab_torch.sh OUT_DIR ARM:SEED [ARM:SEED ...]
#
# Environment: the driver's knobs (AB_STEPS 8000 and AB_PRETRAIN 4000 by
# default here, as docs/SEMI_SUP.md's Protocol B; AB_EVAL_EVERY); AB_LIMIT,
# seconds each process may run (none by default). Exits non-zero if a
# process failed.
# Merge the results with `python -m omni_pq_torch.experiments.semi_sup_report
# --ft OUT_DIR/ab_*.json ...` (a run that AB_LIMIT stopped: its .log).
set -u
out=$1
shift
mkdir -p "$out"
export AB_STEPS=${AB_STEPS:-8000} AB_PRETRAIN=${AB_PRETRAIN:-4000}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
# the kernels once, before the processes (each would build them otherwise)
python -c "from omni_pq_torch.ops import cuda; cuda.build()" || exit 1
pids=()
for run in "$@"; do
    arm=${run%%:*}
    seed=${run##*:}
    name=ab_${arm}_s$seed
    AB_ARMS=$arm AB_SEEDS=$seed AB_OUT=$out/$name.json OMP_NUM_THREADS=2 \
        timeout "${AB_LIMIT:-0}" \
        python -m omni_pq_torch.experiments.semi_sup_ab \
        --doc "$out/$name.md" > "$out/$name.log" 2>&1 &
    pids+=($!)
done
rc=0
for i in "${!pids[@]}"; do
    wait "${pids[$i]}"
    r=$?
    echo "${*:$((i + 1)):1}: exit $r"
    [ $r = 0 ] || rc=1
done
exit $rc
