"""Shared operands, meshes and comparisons of the serving-core tests
(tests/test_torch_serve*.py).

The shapes are tests/test_serve.py's: single-problem n <= 64, the mesh
paths on 2 x 4 at n = 64, nb = 8.  ``slate_tpu`` runs on the 8 forced CPU
devices, the port on a virtual 2 x 4 mesh on the CPU, both fed the same
numpy operands.  Counter deltas compare the flat ``serve.*`` counters
(``slate_tpu``'s serve/metrics.py names) exactly; solutions are held to the
tolerance class of the driver that ran (named at each comparison).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

import slate_tpu.ft as jft
from slate_tpu import obs as jobs
from slate_tpu.parallel.mesh import make_mesh as jmake_mesh
from slate_tpu.serve import metrics as jmetrics
from slate_tpu.serve import router as jrouter_mod
from slate_tpu.serve import trace as jtrace
from slate_tpu.serve.router import Router as JRouter
from slate_tpu.types import Option as JOption
from slate_tpu.types import SlateError as JSlateError
from slate_tpu_torch import obs as tobs
from slate_tpu_torch.ft import inject as tinject
from slate_tpu_torch.ft.policy import FtPolicy
from slate_tpu_torch.obs import metrics as tobs_metrics
from slate_tpu_torch.parallel import make_mesh as tmake_mesh
from slate_tpu_torch.serve import router as trouter_mod
from slate_tpu_torch.serve import trace as rtrace
from slate_tpu_torch.serve.router import Router
from slate_tpu_torch.types import Option, SlateError

EPS = float(np.finfo(np.float64).eps)
COUNTERS = tuple(jmetrics._ZEROS)


def jmesh24():
    return jmake_mesh(2, 4, devices=cpu_devices(8))


def tmesh24():
    return tmake_mesh(2, 4, device="cpu")


def spd_np(rng, n):
    g = rng.standard_normal((n, n))
    return g @ g.T / n + 2 * np.eye(n)


def spd_stack_np(rng, batch, n):
    g = rng.standard_normal((batch, n, n))
    return np.einsum("bij,bkj->bik", g, g) / n + 2 * np.eye(n)[None]


def hostile_np(rng, n, cond_exp=9):
    """A prescribed-spectrum operand at cond 10**cond_exp (past
    CONDEST_THRESHOLD at 9)."""
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q1 @ np.diag(np.logspace(0, -cond_exp, n)) @ q2


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def j(x):
    return jnp.asarray(np.asarray(x))


def counts_pair():
    """(slate_tpu's, the port's) flat serve counters now."""
    jv = jmetrics.serve_counter_values()
    tv = tobs_metrics.serve_counts()
    return {k: jv[k] for k in COUNTERS}, {k: tv[k] for k in COUNTERS}


def deltas(before, after):
    return {k: after[k] - before[k] for k in COUNTERS if after[k] != before[k]}


@contextlib.contextmanager
def counter_deltas():
    """Yields a dict filled on exit with {"jax": deltas, "torch": deltas}."""
    out = {}
    jb, tb = counts_pair()
    yield out
    ja, ta = counts_pair()
    out["jax"], out["torch"] = deltas(jb, ja), deltas(tb, ta)


def clear_admission_memos():
    """Both packages' process-wide max_n memos (max_n_computes counts a
    miss, so deltas compare only from the same memo state)."""
    jrouter_mod._MAX_N_MEMO.clear()
    trouter_mod._MAX_N_MEMO.clear()


def phase_record(tr):
    """A trace's comparable record: phase names in completion order with
    their parents and string metadata, notes, class, bin, batch, outcome
    (latencies are not compared)."""
    return {
        "phases": [(ph["name"], ph["parent"], ph["depth"],
                    tuple(sorted((k, str(v)) for k, v in ph["meta"].items())))
                   for ph in tr.phases],
        "notes": list(tr.notes),
        "klass": tr.klass,
        "bin": tr.bin,
        "batch": tr.batch,
        "outcome": tr.outcome,
        "op": tr.op,
        "n": tr.n,
        "dtype": tr.dtype,
    }


# ---------------------------------------------------------------------------
# the resilient mesh router of both packages (2 x 4, n = 64, nb = 8)
# ---------------------------------------------------------------------------

MESH_N = 64


@pytest.fixture(autouse=True)
def no_mesh_env(monkeypatch):
    """The checkpoint, lowering and monitor environment chains off (autouse
    in the files that import it)."""
    for env in ("SLATE_TPU_CKPT", "SLATE_TPU_CKPT_ASYNC", "SLATE_TPU_PANEL_IMPL",
                "SLATE_TPU_UPDATE_IMPL", "SLATE_TPU_BCAST_IMPL", "SLATE_TPU_NUM"):
        monkeypatch.delenv(env, raising=False)


def _jopts(opts):
    """The same options under slate_tpu's Option and FtPolicy enums."""
    out = {}
    for k, v in opts.items():
        jk = JOption(k.value)
        if isinstance(v, FtPolicy):
            v = jft.FtPolicy(v.value)
        out[jk] = v
    return out


class Side:
    """One package's router, operand conversion, fault injection and
    trace stream."""

    def __init__(self, name, opts):
        self.name = name
        xla = {Option.PanelImpl: "xla"}
        if name == "jax":
            self.router = JRouter(mesh=jmesh24(), nb=8, bins=(MESH_N,), hbm_budget=1 << 30,
                                  opts=_jopts({**xla, **opts}))
            self.conv, self.inj, self.err = j, jft.inject, JSlateError
            self.on, self.traces = jobs.force_enabled, jtrace
        else:
            self.router = Router(mesh=tmesh24(), nb=8, bins=(MESH_N,), hbm_budget=1 << 30,
                                 opts={**xla, **opts})
            self.conv, self.inj, self.err = t, tinject, SlateError
            self.on, self.traces = tobs.force_enabled, rtrace

    def plan(self, kind, *args, **kw):
        if kind == "kill":
            return self.inj.FaultPlan([self.inj.KillFault(*args, **kw)])
        return self.inj.FaultPlan([self.inj.seeded_fault(*args, **kw)])

    def solve(self, op, a, b, plan=None):
        with self.inj.fault_scope(plan):
            x = self.router.solve(op, self.conv(a), self.conv(b))
        return np.asarray(x)


def both(opts):
    return Side("jax", opts), Side("torch", opts)


def mesh_operands(rng, kind="spd"):
    if kind == "spd":
        a = spd_np(rng, MESH_N)
    elif kind == "growth":
        a = rng.standard_normal((MESH_N, MESH_N)) + MESH_N * np.eye(MESH_N)
        a[0, 0] = 1e-9  # nopiv growth explodes; the pp retry swaps it
    else:
        a = rng.standard_normal((MESH_N, MESH_N)) + MESH_N * np.eye(MESH_N)
    return a, rng.standard_normal((MESH_N, 2))
