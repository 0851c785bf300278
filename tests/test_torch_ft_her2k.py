"""The port's checksum-carrying her2k (slate_tpu_torch.ft.abft.her2k_ft)
against slate_tpu.ft.abft.her2k_ft, and the FT smoke's scenario 7.

The same seeded numpy operands and fault plans go through ``slate_tpu`` on
the 8 forced CPU devices (a 2 x 4 mesh) and through the port on a virtual
2 x 4 mesh on the CPU (n = 64 and a ragged 60, nb = 8; f64 and
complex128, her2k and syr2k).  Bitwise: the action (or the FtError), every
detection's kind and tile, the ``ft.*`` counter deltas; the detections'
magnitudes hold to 1e-8 relative and the results to 1e-12 max|C|.  Policy
Off is bitwise the plain full her2k, and Option.FaultTolerance reroutes
her2k_mesh to it, in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu.ft import FaultPlan as JPlan
from slate_tpu.ft import FtError as JFtError
from slate_tpu.ft import FtPolicy as JPolicy
from slate_tpu.ft import abft as jabft
from slate_tpu.ft import fault_scope as jscope
from slate_tpu.ft import inject as jinject
from slate_tpu.ft.policy import ft_counter_values as jcounters
from slate_tpu.parallel import drivers as jdrv
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.types import Option as JOption
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.ft import FaultPlan as TPlan
from slate_tpu_torch.ft import FtError as TFtError
from slate_tpu_torch.ft import FtPolicy as TPolicy
from slate_tpu_torch.ft import abft as tabft
from slate_tpu_torch.ft import fault_scope as tscope
from slate_tpu_torch.ft import inject as tinject
from slate_tpu_torch.ft import smoke as tsmoke
from slate_tpu_torch.ft.policy import ft_counter_values as tcounters
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.types import Option as TOption

torch.set_num_threads(1)

NB = 8
GRID = (2, 4)
KEYS = ("detected", "corrected", "recomputed", "uncorrectable")


def _jmesh():
    return jmake_mesh(*GRID, devices=cpu_devices(8))


def _tmesh():
    return tp.make_mesh(*GRID, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)

    def rnd(shape):
        x = rng.standard_normal(shape)
        if np.dtype(dtype).kind == "c":
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    a, b, g = rnd((n, n)), rnd((n, n)), rnd((n, n))
    return a, b, (g @ g.conj().T + n * np.eye(n)).astype(dtype)


def _ref(a, b, conj, alpha=1.0, beta=0.0, c=None):
    h = (lambda x: x.conj().T) if conj else (lambda x: x.T)
    al2 = np.conj(alpha) if conj else alpha
    out = alpha * a @ h(b) + al2 * b @ h(a)
    return out if c is None else out + beta * c


@pytest.fixture(autouse=True)
def _default_impls(monkeypatch):
    for env in (tk.PANEL_IMPL_ENV, tk.UPDATE_IMPL_ENV, tcomm.BCAST_IMPL_ENV):
        monkeypatch.delenv(env, raising=False)


def _delta(before, after):
    return {k: after[k] - before[k] for k in KEYS}


def _dets(dets):
    return [(d["kind"], tuple(int(x) for x in d["where"])) for d in dets]


def _run(pkg, faults, policy, a, b, conj=True, alpha=1.0, beta=0.0, c=None, la=None):
    """One her2k_ft through one package: {"action" | "error", "dets",
    "delta", "result"}."""
    jax_side = pkg == "jax"
    plan = (JPlan if jax_side else TPlan)([(jinject if jax_side else tinject).Fault(**f)
                                           for f in faults])
    counters = jcounters if jax_side else tcounters
    before = counters()
    out = {}
    try:
        if jax_side:
            with jscope(plan):
                res, rep = jabft.her2k_ft(alpha, jnp.asarray(a), jnp.asarray(b), _jmesh(), NB,
                                          beta=beta, c=None if c is None else jnp.asarray(c),
                                          conj=conj, policy=JPolicy(policy), lookahead=la)
            out["result"] = np.asarray(res)
        else:
            with tscope(plan):
                res, rep = tabft.her2k_ft(alpha, _t(a), _t(b), _tmesh(), NB, beta=beta,
                                          c=None if c is None else _t(c), conj=conj,
                                          policy=TPolicy(policy), lookahead=la)
            out["result"] = res.numpy()
        out["action"], out["dets"] = rep.action, rep.detections
    except (JFtError if jax_side else TFtError) as e:
        out["error"], out["dets"] = (e.op, e.reason), e.detections
    out["delta"] = _delta(before, counters())
    return out


def _same(j, t):
    assert t.get("error") == j.get("error")
    assert t.get("action") == j.get("action")
    assert _dets(t["dets"]) == _dets(j["dets"])
    np.testing.assert_allclose([d["magnitude"] for d in t["dets"]],
                               [d["magnitude"] for d in j["dets"]], rtol=1e-8)
    assert t["delta"] == j["delta"]
    if "result" in j:
        assert np.abs(t["result"] - j["result"]).max() <= 1e-12 * np.abs(j["result"]).max()


def _fault(k, phase, ti, tj, r=None, c=None, value=3.0, mode=None, persist=False):
    return dataclasses.asdict(jinject.Fault(
        "her2k", k=k, phase=phase, ti=ti, tj=tj, r=ti % GRID[0] if r is None else r,
        c=tj % GRID[1] if c is None else c, mode=jinject.MODE_SCALE if mode is None else mode,
        value=value, persist=persist))


# ---------------------------------------------------------------------------
# Off and clean runs (tests/test_ft.py: test_her2k_abft_off_bitwise_and_clean)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_her2k_abft_off_bitwise_and_clean(dtype):
    n = 64
    a, b, _ = _operands(n, dtype)
    mesh = _tmesh()
    off, rep0 = tabft.her2k_ft(1.0, _t(a), _t(b), mesh, NB, policy=TPolicy.Off)
    plain = tp.to_dense(tp.her2k_dist(1.0, tp.from_dense(_t(a), mesh, NB),
                                      tp.from_dense(_t(b), mesh, NB), full=True))[:n, :n]
    assert rep0.clean
    assert torch.equal(off, plain)
    j = _run("jax", [], "detect", a, b)
    t = _run("torch", [], "detect", a, b)
    _same(j, t)
    ref = _ref(a, b, True)
    assert t["action"] == "clean" and np.abs(t["result"] - ref).max() < 1e-12 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# fault outcomes: the same action, detections and counters as slate_tpu
# ---------------------------------------------------------------------------

NT = 8
CASES = {
    # the reference's scenarios (tests/test_ft.py, ft/smoke.py scenario 7)
    "trailing_corrected": ([_fault(NT - 1, "trailing", 3, 1)], "correct"),
    "bcast_repair_or_recompute": ([_fault(2, "bcast", 4, 2, c=1)], "correct"),
    "detect_fail_stops": ([_fault(1, "trailing", 5, 2, value=2.0)], "detect"),
    # more of the ladder
    "panel_phase_corrected": ([_fault(3, "panel", 6, 0)], "correct"),
    "recompute_policy": ([_fault(NT - 1, "trailing", 2, 5)], "recompute"),
    "zeroed_tile": ([_fault(NT - 1, "trailing", 7, 7, mode=jinject.MODE_ZERO)], "correct"),
    "bitflip": ([_fault(4, "trailing", 1, 6, mode=jinject.MODE_FLIP, value=1e3)], "correct"),
    "persistent_double": ([_fault(2, "trailing", 4, 5, persist=True),
                           _fault(3, "trailing", 6, 4, persist=True)], "correct"),
    "early_trailing_live": ([_fault(0, "trailing", 0, 3)], "correct"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_her2k_fault_outcome_matches_jax(name):
    faults, policy = CASES[name]
    a, b, _ = _operands(64)
    j = _run("jax", faults, policy, a, b)
    t = _run("torch", faults, policy, a, b)
    _same(j, t)
    assert t["dets"], "every planted fault is seen at this size in f64"
    if "result" in t:
        ref = _ref(a, b, True)
        assert np.abs(t["result"] - ref).max() < 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("conj", [True, False])
def test_her2k_complex_fault_and_beta_c_match_jax(conj):
    n = 60  # ragged: 7.5 tiles, the checksum rows start in the pad tile's row
    a, b, c0 = _operands(n, np.complex128, seed=3)
    alpha = 1.0 - 0.5j
    faults = [_fault(3, "trailing", 2, 6)]
    j = _run("jax", faults, "correct", a, b, conj=conj, alpha=alpha, beta=0.5, c=c0)
    t = _run("torch", faults, "correct", a, b, conj=conj, alpha=alpha, beta=0.5, c=c0)
    _same(j, t)
    ref = _ref(a, b, conj, alpha, 0.5, c0)
    assert t["action"] == "corrected"
    assert np.abs(t["result"] - ref).max() < 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("la", [0, 2])
def test_her2k_ft_lookahead_depths_agree(la):
    a, b, _ = _operands(64)
    faults = [_fault(NT - 1, "trailing", 3, 1)]
    base = _run("torch", faults, "correct", a, b, la=1)
    t = _run("torch", faults, "correct", a, b, la=la)
    assert t["action"] == base["action"] == "corrected"
    assert _dets(t["dets"]) == _dets(base["dets"]) and t["delta"] == base["delta"]
    np.testing.assert_array_equal(t["result"], base["result"])


def test_her2k_mesh_routes_under_fault_tolerance():
    a, b, c0 = _operands(64, seed=5)
    opts_t = {TOption.FaultTolerance: "correct"}
    opts_j = {JOption.FaultTolerance: "correct"}
    f = _fault(NT - 1, "trailing", 3, 1)
    before = tcounters()
    with tscope(TPlan([tinject.Fault(**f)])):
        t = tp.her2k_mesh(1.0, _t(a), _t(b), _tmesh(), NB, 0.5, _t(c0), opts=opts_t).numpy()
    t_delta = _delta(before, tcounters())
    before = jcounters()
    with jscope(JPlan([jinject.Fault(**f)])):
        j = np.asarray(jdrv.her2k_mesh(1.0, jnp.asarray(a), jnp.asarray(b), _jmesh(), NB, 0.5,
                                       jnp.asarray(c0), opts=opts_j))
    assert t_delta == _delta(before, jcounters()) and t_delta["corrected"] > 0  # ABFT ran
    ref = _ref(a, b, True, 1.0, 0.5, c0)
    assert np.abs(t - ref).max() < 1e-12 * np.abs(ref).max()
    assert np.abs(t - j).max() <= 1e-12 * np.abs(j).max()
    plain = tp.her2k_mesh(1.0, _t(a), _t(b), _tmesh(), NB, 0.5, _t(c0)).numpy()
    assert np.abs(plain - ref).max() < 1e-12 * np.abs(ref).max()


def test_her2k_ft_shape_mismatch_raises():
    a, b, _ = _operands(16)
    with pytest.raises(ValueError):
        tabft.her2k_ft(1.0, _t(a), _t(b[:, :8]), _tmesh(), NB)


# ---------------------------------------------------------------------------
# the FT smoke: seven scenarios, the reference's counter floors
# ---------------------------------------------------------------------------


def test_ft_smoke_runs_seven_scenarios_at_the_reference_floors():
    res = tsmoke.run_smoke("cpu")
    assert res["ok"], res
    assert set(res["scenarios"]) == {"gemm", "potrf", "getrf_nopiv", "recompute",
                                     "double_fault", "trsm", "her2k", "counters"}
    c = res["counters"]
    assert c["detected"] >= 7 and c["corrected"] >= 5
    assert c["recomputed"] >= 1 and c["uncorrectable"] >= 1


def test_smoke_scenario_7_matches_jax():
    # slate_tpu/ft/smoke.py scenario 7: randn A (seed 0), B (seed 1), a
    # trailing fault on tile (3, 1) at the last step, scaled by 3
    from slate_tpu.utils.testing import generate

    n = 64
    a, b = generate("randn", n, seed=0), generate("randn", n, seed=1)
    faults = [_fault(NT - 1, "trailing", 3, 1)]
    j = _run("jax", faults, "correct", a, b)
    t = _run("torch", faults, "correct", a, b)
    _same(j, t)
    ref = a @ b.T + b @ a.T
    assert t["action"] == "corrected"
    assert np.abs(t["result"] - ref).max() / np.abs(ref).max() < 1e-12
