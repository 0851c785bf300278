"""The port's resilient mesh router and gels tier against slate_tpu's: the
degradation ladder (FtError retry, Preempted resume, unresumable reject,
GrowthAbort pivoted retry) with equal counters and solutions.

tests/test_serve.py's shapes: a 2 x 4 mesh, n = 64, nb = 8, bins (64,),
Option.Checkpoint every 3 steps, the panel lowering pinned to ``xla`` on
both sides (the info-parity rule).  Held exactly: the ``serve.*`` counter
deltas.  Solutions: the residual gate of tests/test_serve.py
(max|A x - b| < 1e-8) and the two packages' x within 1e-9 (the mesh
factors' f64 class at n = 64); the resumed solve is bitwise the port's
unbroken chain's.
"""

import gc

import jax
import numpy as np
import pytest
import torch

from torch_serve_common import (
    Side,
    both,
    clear_admission_memos,
    counter_deltas,
    mesh_operands as operands,
    no_mesh_env,  # noqa: F401 (an autouse fixture)
)

from slate_tpu_torch.ft.policy import FtPolicy
from slate_tpu_torch.types import Option, SlateError

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


CASES = {
    # name: (opts, op, operand kind, fault plan args, counter expected)
    "ft_retry": ({Option.FaultTolerance: FtPolicy.Detect}, "posv", "spd",
                 ("fault", 12, "potrf", 8, (2, 4)), {"phase": "panel"}, {"retries": 1}),
    "resume": ({Option.Checkpoint: 3}, "posv", "spd", ("kill", "potrf", 4), {},
               {"resumes": 1}),
    "clean": ({Option.Checkpoint: 3}, "posv", "spd", None, {}, {}),
    "growth": ({Option.Checkpoint: 3, Option.NumMonitor: "on"}, "gesv", "growth", None, {},
               {"retries": 1, "class_hostile": 1}),
    "nopiv": ({Option.Checkpoint: 3, Option.NumMonitor: "on"}, "gesv", "dom", None, {},
              {"class_friendly": 1}),
    "pp": ({Option.Checkpoint: 3, Option.NumMonitor: "off"}, "gesv", "dom", None, {},
           {"class_hostile": 1}),
    "gesv_ft": ({Option.FaultTolerance: FtPolicy.Detect}, "gesv", "dom",
                ("fault", 5, "getrf_nopiv", 8, (2, 4)), {"phase": "panel"}, {"retries": 1}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resilient_router_matches_jax(rng, case):
    """Each rung of the ladder in both packages: equal counter deltas, the
    residual gate, x within the mesh factors' f64 class of slate_tpu's."""
    opts, op, kind, fargs, fkw, want = CASES[case]
    a, b = operands(rng, kind)
    clear_admission_memos()
    sides = both({**opts, Option.NumMonitor: opts.get(Option.NumMonitor, "off")})
    xs = {}
    with counter_deltas() as d:
        for s in sides:
            plan = s.plan(fargs[0], *fargs[1:], **fkw) if fargs else None
            xs[s.name] = s.solve(op, a, b, plan)
    assert d["jax"] == d["torch"], (d["jax"], d["torch"])
    for k, v in want.items():
        assert d["torch"][k] == v, (k, d["torch"])
    assert np.abs(a @ xs["torch"] - b).max() < 1e-8
    np.testing.assert_allclose(xs["torch"], xs["jax"], rtol=1e-9, atol=1e-11)


def test_resume_is_bitwise_the_unbroken_chain(rng):
    """The resumed request's answer equals the unbroken checkpointed
    chain's bit for bit (the resume restarts from the snapshot's carry)."""
    a, b = operands(rng)
    r = Side("torch", {Option.Checkpoint: 3, Option.NumMonitor: "off"})
    x_clean = r.solve("posv", a, b)
    x_resumed = r.solve("posv", a, b, r.plan("kill", "potrf", 4))
    np.testing.assert_array_equal(x_resumed, x_clean)


def test_router_rejects_unresumable_preemption(rng):
    """A kill before the first snapshot, and a re-kill on resume, are
    rejected with a structured error in both packages (two
    admission_rejects), never served NaNs."""
    a, b = operands(rng)
    clear_admission_memos()
    sides = both({Option.Checkpoint: 3, Option.NumMonitor: "off"})
    with counter_deltas() as d:
        for s in sides:
            with pytest.raises(s.err, match="unresumable"):
                s.solve("posv", a, b, s.plan("kill", "potrf", 1))
            with pytest.raises(s.err, match="re-preempted"):
                s.solve("posv", a, b, s.plan("kill", "potrf", 4, persist=True))
    assert d["jax"] == d["torch"] and d["torch"]["admission_rejects"] == 2


def test_ft_and_checkpoint_together_refused(rng):
    a, b = operands(rng)
    s = Side("torch", {Option.Checkpoint: 3, Option.FaultTolerance: FtPolicy.Detect})
    with pytest.raises(SlateError, match="cannot be combined"):
        s.solve("posv", a, b)
