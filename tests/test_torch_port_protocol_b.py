"""Protocol B's resume, the port against the JAX driver, on the CPU: P=3
supervised steps, the teacher backfill, then S=4 steps of the arm, for
`gamma_ft` and `arkit_centered_ft`, held together after every step.

The one-step tests (tests/test_torch_port_semi.py) hold a semi step at EMA
step 1, where alpha = 0.5. A long Protocol-B run leans on what they cannot
see: the optimiser's moments and step counter carried across the resume,
the backfill (teacher := student, parameters and BN buffers), the EMA rule
on a counter the backfill does not reset (omni_pq_tpu/train/state.py:40:
alpha = min(1 - 1/(step+1), decay): 0.8, 0.83, 0.86, 0.875 at steps 4-7
here, 0.999 from step 4001 of the driver's run), and the consistency
weight switched on at the resume.

Both packages run in a process of their own with JAX's 64-bit types on
(tests/torch_protocol_b_run.py says what each runs, and why float64: in
float32 the two trajectories part within a step, through Adam's sign-like
first updates of elements whose gradient is roundoff). Bounds, over every
step (the largest gap measured on this setup in brackets):
- stats within 3e-5 of each stat's magnitude [1.4e-6];
- the student's parameters within 1e-3 lr elementwise [2.3e-5 lr];
- AdamW's mu and nu within 1e-4 of each tensor's largest magnitude,
  floored at 1e-3 (mu) and 1e-6 (nu) of the largest tensor's [3.8e-6];
- BN running statistics of student and teacher within 3e-6 of each
  buffer's largest magnitude [1.3e-7];
- the step counter and AdamW's update count equal in both;
- the teacher unchanged in the supervised phase; from the backfill, within
  the gap the EMA rule carries over from the two students' gaps
  (err <- alpha err + (1 - alpha) student gap, from the students' gap at
  the backfill, + 1e-12);
- the EMA alpha each package applied, measured from its tensors, within
  1e-9 of min(1 - 1/(step+1), 0.999) at JAX's step counter [0].
Up to the backfill every gap is float64 roundoff (<= 6e-8 lr, 1e-10 of a
stat). From the first semi step the teacher's end points are float32 in
both packages (the JAX step casts them, omni_pq_tpu/train/step.py:132-134),
where XLA's and ATen's float32 exp and log differ in the last bit (1e-7 of
the class-consistency stats, tests/test_torch_port_float64.py), and Adam's
eps magnifies that noise on gradients near eps: the semi phase's gaps grow
from it. A fault of the resume moves them by orders of magnitude more: the
controls (the port with the backfill skipped, and with the EMA counter
reset at the resume) fail these bounds at the first semi step (the teacher
1e8-1e9 times past its bound, the stats 0.4 apart when the backfill is
skipped, the measured alpha 0.5 against 0.8 when the counter is reset).
"""
import json
import os
import subprocess
import sys

import pytest

from tests.torch_protocol_b_run import ARMS, CONTROLS, P, STEPS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"stats": 3e-5, "student": 1e-3, "mu": 1e-4, "nu": 1e-4, "bn": 3e-6,
       "ema_bn": 3e-6, "counters": 0.0, "alpha": 1e-9}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs and the controls, from their own process."""
    tmp = tmp_path_factory.mktemp("protocol_b")
    out, log = tmp / "gaps.json", tmp / "run.log"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    with open(log, "w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", "tests.torch_protocol_b_run", str(out)],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
            timeout=1200).returncode
    assert rc == 0, log.read_text()[-4000:]
    with open(out) as f:
        return json.load(f)


def failed_checks(step_gaps, semi):
    """The checks of one step past their bounds: {check: [gap, where]}."""
    bad = {k: g for k, g in step_gaps.items() if k in TOL and g[0] > TOL[k]}
    # the teacher: a ratio to its carried bound in the semi phase, before
    # it its largest change
    if step_gaps["teacher"][0] > (1.0 if semi else 0.0):
        bad["teacher"] = step_gaps["teacher"]
    return bad


@pytest.mark.parametrize("arm", ARMS)
def test_protocol_b_resume_matches_jax(runs, arm):
    gaps = runs[arm]["port"]
    assert len(gaps) == STEPS
    for i, g in enumerate(gaps):
        semi = i >= P
        assert set(TOL) - {"alpha"} <= set(g) and ("alpha" in g) == semi
        assert not failed_checks(g, semi), (f"step {i + 1}",
                                            failed_checks(g, semi))
    # the semi phase ran what the arm is about: the consistency term on at
    # the resume, the criterion engaged, the ARKit loss found collisions
    stats = runs[arm]["stats"]
    assert all("weighted_consistency_loss" not in s for s in stats[:P])
    assert all(s["weighted_consistency_loss"] > 0 for s in stats[P:])
    assert max(s["gamma_engaged_frac"] for s in stats[P:]) > 0
    if arm.startswith("arkit"):
        assert min(s["arkit_collisions"] for s in stats[P:]) > 0


@pytest.mark.parametrize("control", CONTROLS)
@pytest.mark.parametrize("arm", ARMS)
def test_broken_resume_fails_the_bounds(runs, arm, control):
    """The port with the backfill skipped, or with the EMA counter reset at
    the resume, fails the bounds at the first semi step; its supervised
    steps are the faithful run's."""
    gaps, good = runs[arm][control], runs[arm]["port"]
    assert gaps[:P] == good[:P]
    bad = failed_checks(gaps[P], semi=True)
    assert "teacher" in bad and bad["teacher"][0] > 1e3, bad
    if control == "skip_backfill":
        assert bad["stats"][0] > 0.1, bad
    else:
        assert bad["alpha"][0] > 0.1 and bad["counters"][0] == 1, bad
