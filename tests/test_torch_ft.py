"""The port's ABFT layer (slate_tpu_torch.ft) against slate_tpu.ft.

The same seeded numpy operands and the same fault plans go through
``slate_tpu``'s checksum-carrying mesh drivers on the 8 forced CPU devices
of conftest.py (a 2 x 4 mesh) and through the port's on a virtual 2 x 4
mesh on the CPU, at tests/test_ft.py's sizes (n = 64, nb = 8, and a ragged
n = 60).  Both sides pin Option.PanelImpl: ``xla`` (slate_tpu's CPU default)
for the fault parity, ``pallas`` (the Pallas kernels interpreted, the
port's kernel twins) where a test says so, since ``auto`` means xla in
``slate_tpu`` on the CPU and the twins in the port.

Bitwise: every FtReport action, every detection's kind and where, the
FtError raises, the ``ft.*`` counter deltas, the seeded fault draws and
spec arrays, the flagged / located indices of the checksum algebra, and
the port's own results across lookahead depths.  Detection magnitudes
hold to rtol 1e-8 in f64 (the discrepancy of a fault is the fault itself;
the frameworks' rounding differs in the last bits), results to
1e-12 max|ref| in f64.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import api as japi
from slate_tpu.ft import FaultPlan as JPlan
from slate_tpu.ft import FtError as JFtError
from slate_tpu.ft import FtPolicy as JPolicy
from slate_tpu.ft import abft as jabft
from slate_tpu.ft import checksum as jcks
from slate_tpu.ft import fault_scope as jscope
from slate_tpu.ft import inject as jinject
from slate_tpu.ft.policy import ft_counter_values as jcounters
from slate_tpu.obs import REGISTRY as JREG
from slate_tpu.parallel import drivers as jdrv
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu.types import Option as JOption
from slate_tpu_torch import api as tapi
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.ft import FaultPlan as TPlan
from slate_tpu_torch.ft import FtError as TFtError
from slate_tpu_torch.ft import FtPolicy as TPolicy
from slate_tpu_torch.ft import abft as tabft
from slate_tpu_torch.ft import checksum as tcks
from slate_tpu_torch.ft import fault_scope as tscope
from slate_tpu_torch.ft import inject as tinject
from slate_tpu_torch.ft.policy import ft_counter_values as tcounters
from slate_tpu_torch.obs import REGISTRY as TREG
from slate_tpu_torch.types import Option as TOption

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

N, NB = 64, 8
GRID = (2, 4)
KEYS = ("detected", "corrected", "recomputed", "uncorrectable")


def _jmesh():
    return jmake_mesh(*GRID, devices=cpu_devices(8))


def _tmesh():
    return tp.make_mesh(*GRID, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _operands(n, seed=0, dtype=np.float64):
    """randn A and B, an SPD matrix (G G^T + n I) and a diagonally dominant
    one (randn + n I), from one numpy generator."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    g = rng.standard_normal((n, n))
    spd = g @ g.T + n * np.eye(n)
    dd = rng.standard_normal((n, n)) + n * np.eye(n)
    return {k: v.astype(dtype) for k, v in
            {"a": a, "b": b, "spd": spd, "dd": dd}.items()}


def _delta(before, after):
    return {k: after[k] - before[k] for k in KEYS}


def _dets(dets):
    return [(d["kind"], tuple(int(x) for x in d["where"])) for d in dets]


def _mags(dets):
    return np.array([d["magnitude"] for d in dets])


# one runner per package: (op, operands, policy, fault dicts, knobs) ->
# {"action" | "error", detections, counter delta, result}

def _run_jax(op, ops, policy, faults, n, la=None, pi="xla"):
    mesh, pol = _jmesh(), JPolicy(policy)
    plan = JPlan([jinject.Fault(**f) for f in faults])
    before = jcounters()
    out = {}
    try:
        with jscope(plan):
            if op == "gemm":
                c, rep = jabft.gemm_ft(1.0, jnp.asarray(ops["a"]), jnp.asarray(ops["b"]), mesh, NB,
                                       policy=pol, lookahead=la, panel_impl=pi)
                out["result"] = np.asarray(c)
            elif op == "potrf":
                l, info, rep = jabft.potrf_ft(jnp.asarray(ops["spd"]), mesh, NB, policy=pol,
                                              lookahead=la, panel_impl=pi)
                out["result"], out["info"] = np.tril(np.asarray(jto_dense(l)))[:n, :n], int(info)
            else:
                lu, info, rep = jabft.getrf_nopiv_ft(jnp.asarray(ops["dd"]), mesh, NB, policy=pol,
                                                     lookahead=la, panel_impl=pi)
                out["result"], out["info"] = np.asarray(jto_dense(lu))[:n, :n], int(info)
        out["action"], out["dets"] = rep.action, rep.detections
    except JFtError as e:
        out["error"], out["dets"] = (e.op, e.reason), e.detections
    out["delta"] = _delta(before, jcounters())
    return out


def _run_torch(op, ops, policy, faults, n, la=None, pi="xla"):
    mesh, pol = _tmesh(), TPolicy(policy)
    plan = TPlan([tinject.Fault(**f) for f in faults])
    before = tcounters()
    out = {}
    try:
        with tscope(plan):
            if op == "gemm":
                c, rep = tabft.gemm_ft(1.0, _t(ops["a"]), _t(ops["b"]), mesh, NB, policy=pol,
                                       lookahead=la, panel_impl=pi)
                out["result"] = c.numpy()
            elif op == "potrf":
                l, info, rep = tabft.potrf_ft(_t(ops["spd"]), mesh, NB, policy=pol, lookahead=la,
                                              panel_impl=pi)
                out["result"], out["info"] = np.tril(tp.to_dense(l).numpy())[:n, :n], int(info)
            else:
                lu, info, rep = tabft.getrf_nopiv_ft(_t(ops["dd"]), mesh, NB, policy=pol,
                                                     lookahead=la, panel_impl=pi)
                out["result"], out["info"] = tp.to_dense(lu).numpy()[:n, :n], int(info)
        out["action"], out["dets"] = rep.action, rep.detections
    except TFtError as e:
        out["error"], out["dets"] = (e.op, e.reason), e.detections
    out["delta"] = _delta(before, tcounters())
    return out


def _same(j, t):
    """The port's outcome is slate_tpu's: action (or FtError), detections'
    kind/where bitwise, magnitudes to rtol 1e-8, the same counter deltas,
    info, and the result to 1e-12 max|ref|."""
    assert t.get("error") == j.get("error")
    assert t.get("action") == j.get("action")
    assert _dets(t["dets"]) == _dets(j["dets"])
    np.testing.assert_allclose(_mags(t["dets"]), _mags(j["dets"]), rtol=1e-8)
    assert t["delta"] == j["delta"]
    assert t.get("info") == j.get("info")
    if "result" in j:
        scale = np.abs(j["result"]).max()
        assert np.abs(t["result"] - j["result"]).max() <= 1e-12 * scale


def _seeded(seed, op, nt, phase, persist=False):
    return dataclasses.asdict(jinject.seeded_fault(seed, op, nt, GRID, phase=phase, persist=persist))


@pytest.fixture(scope="module")
def ops64():
    return _operands(N)


@pytest.fixture(scope="module")
def ops60():
    return _operands(60, seed=1)


# ---------------------------------------------------------------------------
# FT off, bad policy, option plumbing (the port alone)
# ---------------------------------------------------------------------------


def test_ft_off_bitwise_identical(ops64):
    mesh = _tmesh()
    a, b, spd, dd = (_t(ops64[k]) for k in ("a", "b", "spd", "dd"))
    plain = tp.gemm_mesh(1.0, a, b, mesh, NB)
    for off in ("off", TPolicy.Off):
        opts = {TOption.FaultTolerance: off}
        assert torch.equal(tp.gemm_mesh(1.0, a, b, mesh, NB, opts=opts), plain)
        l0, i0 = tp.potrf_mesh(spd, mesh, NB)
        l1, i1 = tp.potrf_mesh(spd, mesh, NB, opts=opts)
        assert torch.equal(l0.tiles, l1.tiles) and int(i0) == int(i1) == 0
        u0, j0 = tp.getrf_nopiv_mesh(dd, mesh, NB)
        u1, j1 = tp.getrf_nopiv_mesh(dd, mesh, NB, opts=opts)
        assert torch.equal(u0.tiles, u1.tiles) and int(j0) == int(j1) == 0
    c, rep = tabft.gemm_ft(1.0, a, b, mesh, NB, policy=TPolicy.Off)
    assert rep.clean and torch.equal(c, plain)
    # the inputs are never written
    assert np.array_equal(a.numpy(), ops64["a"]) and np.array_equal(spd.numpy(), ops64["spd"])


def test_bad_policy_rejected(ops64):
    mesh = _tmesh()
    a = _t(ops64["a"])
    bad = {TOption.FaultTolerance: "warp-speed"}
    with pytest.raises(ValueError, match="FaultTolerance"):
        tp.gemm_mesh(1.0, a, a, mesh, NB, opts=bad)
    with pytest.raises(ValueError, match="FaultTolerance"):
        tp.potrf_mesh(_t(ops64["spd"]), mesh, NB, opts=bad)
    with pytest.raises(ValueError, match="FaultTolerance"):
        tapi.multiply(1.0, a, a, opts=bad, device="cpu")
    with pytest.raises(ValueError):
        japi.multiply(1.0, jnp.asarray(ops64["a"]), jnp.asarray(ops64["a"]),
                      opts={JOption.FaultTolerance: "warp-speed"})


def test_ft_and_checkpoint_refusals(ops64, monkeypatch):
    mesh = _tmesh()
    spd = _t(ops64["spd"])
    with pytest.raises(ValueError, match="cannot be combined"):
        tp.potrf_mesh(spd, mesh, NB, opts={TOption.FaultTolerance: "correct", TOption.Checkpoint: 2})
    with pytest.raises(ValueError, match="cannot be combined"):
        jdrv.potrf_mesh(jnp.asarray(ops64["spd"]), _jmesh(), NB,
                        opts={JOption.FaultTolerance: "correct", JOption.Checkpoint: 2})
    # Checkpoint alone is ported: the checkpointed chain, the plain bits
    l0, info0 = tp.potrf_mesh(spd, mesh, NB)
    l1, info1 = tp.potrf_mesh(spd, mesh, NB, opts={TOption.Checkpoint: 2})
    assert torch.equal(l0.tiles, l1.tiles) and int(info0) == int(info1) == 0
    monkeypatch.setenv("SLATE_TPU_CKPT", "3")
    with pytest.raises(ValueError, match="cannot be combined"):
        tp.getrf_nopiv_mesh(_t(ops64["dd"]), mesh, NB, opts={TOption.FaultTolerance: "detect"})


# ---------------------------------------------------------------------------
# checksum algebra and the fault spec (no mesh)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ti,tj,scale", [(3, 2, 2.0), (0, 4, -1.0), (5, 0, 1e3)])
def test_checksum_encode_locate_roundtrip(ti, tj, scale):
    nb, mt, nt = 4, 6, 5
    a = np.random.default_rng(ti + 7 * tj).standard_normal((mt * nb, nt * nb))
    for side in ("row", "col"):
        tf, jf = (tcks.row_checksums, jcks.row_checksums) if side == "row" else \
            (tcks.col_checksums, jcks.col_checksums)
        cs_t, cs_j = tf(_t(a), nb).numpy(), np.asarray(jf(jnp.asarray(a), nb))
        np.testing.assert_allclose(cs_t, cs_j, rtol=0, atol=1e-12 * np.abs(cs_j).max())
        bad = a.copy()
        bad[ti * nb:(ti + 1) * nb, tj * nb:(tj + 1) * nb] *= scale
        d = cs_t - tf(_t(bad), nb).numpy()
        if side == "row":
            d1, d2 = d[:nb, tj * nb:(tj + 1) * nb], d[nb:, tj * nb:(tj + 1) * nb]
            want = ti
        else:
            d1, d2 = d[ti * nb:(ti + 1) * nb, :nb], d[ti * nb:(ti + 1) * nb, nb:]
            want = tj
        loc = tcks.ratio_locate(d1, d2, mt if side == "row" else nt)
        assert loc == want == jcks.ratio_locate(d1, d2, mt if side == "row" else nt)
        # the unit discrepancy added back restores the tile exactly
        fixed = bad.copy()
        fixed[ti * nb:(ti + 1) * nb, tj * nb:(tj + 1) * nb] += d1
        np.testing.assert_allclose(fixed, a, rtol=0, atol=1e-12 * np.abs(a).max())
    assert tcks.threshold(100, torch.float32, 2.0) == jcks.threshold(100, jnp.float32, 2.0)
    assert tcks.threshold(100, torch.float64, 0.5) == jcks.threshold(100, jnp.float64, 0.5)


def test_checksum_nonfinite_flags():
    d = np.zeros(6)
    d[2], d[4] = np.nan, np.inf
    assert list(tcks.flag_mismatches(d, tol=1.0)) == list(jcks.flag_mismatches(d, tol=1.0)) == [2, 4]
    nan = np.full((2, 2), np.nan)
    assert tcks.ratio_locate(nan, np.ones((2, 2)), 4) == jcks.ratio_locate(nan, np.ones((2, 2)), 4) == -1
    x = np.array([[1.0, np.nan], [-np.inf, -3.0]])
    assert tcks.finite_max(x) == tcks.finite_max(_t(x)) == jcks.finite_max(x) == 3.0


@pytest.mark.parametrize("op", ["gemm", "potrf", "getrf_nopiv", "trsm"])
def test_seeded_draws_and_spec_arrays_match(op):
    phases = ["bcast", "trailing"] if op == "gemm" else ["panel", "bcast", "trailing", None]
    for seed in range(40):
        for phase in phases:
            for persist in (False, True):
                fj = jinject.seeded_fault(seed, op, 8, GRID, phase=phase, persist=persist)
                ft = tinject.seeded_fault(seed, op, 8, GRID, phase=phase, persist=persist)
                assert dataclasses.asdict(ft) == dataclasses.asdict(fj)
        kj = jinject.seeded_kill(seed, op, 9, in_segment=bool(seed % 2))
        assert dataclasses.asdict(tinject.seeded_kill(seed, op, 9, in_segment=bool(seed % 2))) == \
            dataclasses.asdict(kj)
    faults = [_seeded(5, op, 8, phases[0]), _seeded(6, op, 8, phases[1], persist=True)]
    with jscope(JPlan([jinject.Fault(**f) for f in faults])):
        ij, vj = jinject.spec_arrays(op)
    with tscope(TPlan([tinject.Fault(**f) for f in faults])):
        it, vt = tinject.spec_arrays(op)
    assert np.array_equal(it, ij) and it.dtype == ij.dtype
    assert np.array_equal(vt, vj) and vt.dtype == vj.dtype
    # more than MAX_FAULTS armed faults raise, as in slate_tpu
    three = [tinject.Fault(**_seeded(s, op, 8, phases[0])) for s in (1, 2, 3)]
    with tscope(TPlan(three)):
        with pytest.raises(ValueError, match="MAX_FAULTS"):
            tinject.spec_arrays(op)
    with pytest.raises(ValueError):
        tinject.seeded_fault(0, op, 3, GRID)


# ---------------------------------------------------------------------------
# clean runs: quiet in f32 and f64, the online discrepancy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pi", ["xla", "pallas"])
def test_detect_clean(dtype, pi):
    ops = _operands(N, seed=3, dtype=dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-4
    before = tcounters()
    mesh = _tmesh()
    a, b = _t(ops["a"]), _t(ops["b"])
    c, rep = tabft.gemm_ft(1.0, a, b, mesh, NB, policy=TPolicy.Detect, panel_impl=pi)
    ref = ops["a"].astype(np.float64) @ ops["b"]
    assert rep.clean and np.abs(c.numpy() - ref).max() / np.abs(ref).max() < tol
    l, info, rep = tabft.potrf_ft(_t(ops["spd"]), mesh, NB, policy=TPolicy.Detect, panel_impl=pi)
    ld = np.tril(tp.to_dense(l).numpy()).astype(np.float64)
    assert rep.clean and int(info) == 0
    assert np.abs(ld @ ld.T - ops["spd"]).max() / np.abs(ops["spd"]).max() < tol * 10
    lu, info, rep = tabft.getrf_nopiv_ft(_t(ops["dd"]), mesh, NB, policy=TPolicy.Detect,
                                         panel_impl=pi)
    lud = tp.to_dense(lu).numpy().astype(np.float64)
    resid = (np.tril(lud, -1) + np.eye(N)) @ np.triu(lud) - ops["dd"]
    assert rep.clean and int(info) == 0
    assert np.abs(resid).max() / np.abs(ops["dd"]).max() < tol * 10
    assert tcounters() == before  # nothing flagged


def test_online_discrepancy_matches_pallas(ops64):
    """Under PanelImpl pallas both packages fuse the checksum sums into the
    SUMMA step (slate_tpu's Pallas kernel interpreted, the port's twin) and
    record ft.online_disc: both far inside the host verify's clean
    threshold, and within it of each other.  Under xla neither does."""
    a, b = ops64["a"], ops64["b"]
    JREG.reset()
    TREG.reset()
    cj, _ = jabft.gemm_ft(1.0, jnp.asarray(a), jnp.asarray(b), _jmesh(), NB,
                          policy=JPolicy.Detect, panel_impl="pallas")
    ct, _ = tabft.gemm_ft(1.0, _t(a), _t(b), _tmesh(), NB, policy=TPolicy.Detect,
                          panel_impl="pallas")
    dj = JREG.snapshot()["gauges"][0]["value"]
    dt = TREG.gauge_value("ft.online_disc", op="gemm")
    kt = mt = N // NB
    tol = tcks.threshold((kt + mt) * NB, torch.float64, mt * float(np.abs(np.asarray(cj)).max()))
    assert 0 <= dt < 1e-2 * tol and 0 <= dj < 1e-2 * tol
    assert abs(dt - dj) < tol
    TREG.reset()
    tabft.gemm_ft(1.0, _t(a), _t(b), _tmesh(), NB, policy=TPolicy.Detect, panel_impl="xla")
    assert TREG.gauge_value("ft.online_disc", op="gemm") is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_gemm_ft_fuses_in_f32(ops64, dtype):
    """Under PanelImpl pallas a bf16/f16 gemm_ft takes the fused step (the
    kernel takes f32/f64, so the product accumulates in f32 and rounds once
    at the end): it records ft.online_disc, verifies clean, and returns the
    input dtype within 2 eps_half max|C| of the f32 product of the same
    rounded operands."""
    a, b = _t(ops64["a"]).to(dtype), _t(ops64["b"]).to(dtype)
    TREG.reset()
    c, rep = tabft.gemm_ft(1.0, a, b, _tmesh(), NB, policy=TPolicy.Detect, panel_impl="pallas")
    ref = a.float() @ b.float()
    assert rep.clean and c.dtype == dtype
    assert TREG.gauge_value("ft.online_disc", op="gemm") >= 0
    eps = torch.finfo(dtype).eps
    assert float((c.float() - ref).abs().max()) <= 2 * eps * float(ref.abs().max())


def test_gemm_ft_lookahead_depth_invariant(ops64):
    # the checksum panels ride prefetch_bcast: every depth is bitwise-equal
    for pi in ("xla", "pallas"):
        outs = [tabft.gemm_ft(1.0, _t(ops64["a"]), _t(ops64["b"]), _tmesh(), NB,
                              policy=TPolicy.Detect, lookahead=la, panel_impl=pi)[0]
                for la in (0, 1, 2)]
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# injected faults at every phase: the same decisions as slate_tpu
# ---------------------------------------------------------------------------

FAULT_CASES = (
    [("gemm", s, ph) for s, ph in [(21, "trailing"), (22, "bcast"), (23, "trailing"),
                                    (24, "bcast"), (25, "bcast"), (26, "trailing")]]
    + [("potrf", s, ph) for s, ph in [(31, "panel"), (32, "bcast"), (33, "trailing"),
                                       (34, "panel"), (35, "bcast"), (36, "trailing")]]
    + [("getrf_nopiv", s, ph) for s, ph in [(41, "panel"), (42, "bcast"), (43, "trailing"),
                                             (44, "panel"), (45, "bcast"), (46, "trailing")]]
)


@pytest.mark.parametrize("op,seed,phase", FAULT_CASES,
                         ids=[f"{o}-{s}-{p}" for o, s, p in FAULT_CASES])
def test_fault_parity(ops64, op, seed, phase):
    f = _seeded(seed, op, N // NB, phase)
    j = _run_jax(op, ops64, "correct", [f], N)
    t = _run_torch(op, ops64, "correct", [f], N)
    assert j["action"] in ("corrected", "recomputed") and j["dets"]
    _same(j, t)


@pytest.mark.parametrize("op,seed,phase", [("gemm", 21, "trailing"), ("potrf", 31, "panel"),
                                           ("getrf_nopiv", 43, "trailing")])
def test_fault_parity_ragged(ops60, op, seed, phase):
    f = _seeded(seed, op, 8, phase)  # n = 60 pads to 8 tiles of 8
    _same(_run_jax(op, ops60, "correct", [f], 60), _run_torch(op, ops60, "correct", [f], 60))


@pytest.mark.parametrize("op,seed,phase", [("gemm", 22, "bcast"), ("potrf", 31, "panel"),
                                           ("getrf_nopiv", 42, "bcast")])
def test_fault_parity_pallas(ops64, op, seed, phase):
    """PanelImpl pallas on both sides: slate_tpu's Pallas kernels
    interpreted, the port's kernel twins (the fused SUMMA step, the
    Cholesky and LU panels) — the same decisions."""
    f = _seeded(seed, op, N // NB, phase)
    _same(_run_jax(op, ops64, "correct", [f], N, pi="pallas"),
          _run_torch(op, ops64, "correct", [f], N, pi="pallas"))


# f32 at n = 768 (96 tile steps of 8): the threshold 64 ops eps mt max|out|
# is ~1.1 max|C| (gemm) / ~0.56 max|F| (factors), so small seeded faults
# stay below it in both packages; a scale-by-1000 panel fault does not
BLIND_N = 768
BLIND_CASES = [("gemm", 21, "trailing", "clean"), ("potrf", 12, "panel", "clean"),
               ("getrf_nopiv", 12, "panel", "clean"), ("potrf", 31, "panel", "corrected")]


@pytest.fixture(scope="module")
def ops768():
    return _operands(BLIND_N, seed=5, dtype=np.float32)


@pytest.mark.parametrize("op,seed,phase,action", BLIND_CASES,
                         ids=[f"{o}-{s}-{p}" for o, s, p, _ in BLIND_CASES])
def test_fault_parity_f32_blind_regime(ops768, op, seed, phase, action):
    """Where the f32 threshold exceeds the seeded fault's checksum
    discrepancy, the port accepts "clean" exactly where slate_tpu does:
    the same action, no detections, the same counter deltas and info, and
    the same (faulty) result to n eps32 max|ref|."""
    f = _seeded(seed, op, BLIND_N // NB, phase)
    j = _run_jax(op, ops768, "correct", [f], BLIND_N)
    t = _run_torch(op, ops768, "correct", [f], BLIND_N)
    assert j["action"] == t["action"] == action
    assert _dets(t["dets"]) == _dets(j["dets"]) and (action == "clean") == (not j["dets"])
    assert t["delta"] == j["delta"] and t.get("info") == j.get("info")
    scale = np.abs(j["result"]).max()
    assert np.abs(t["result"] - j["result"]).max() <= BLIND_N * np.finfo(np.float32).eps * scale


# trailing faults whose tile the lookahead narrow update refreshes (the
# column slot of the next panel, or for LU its row slot): the hook must
# fire exactly once, in the narrow half at depth >= 1
NARROW_FAULTS = {
    "potrf": dict(op="potrf", k=1, phase="trailing", ti=5, tj=2, r=1, c=2, mode=2, value=3.0,
                  persist=False),
    "getrf_nopiv": dict(op="getrf_nopiv", k=1, phase="trailing", ti=3, tj=6, r=1, c=2, mode=3,
                        value=3.0, persist=False),
}


@pytest.mark.parametrize("op", ["potrf", "getrf_nopiv"])
def test_fault_detections_across_lookahead(ops64, op):
    for f in (NARROW_FAULTS[op], _seeded(33 if op == "potrf" else 43, op, N // NB, "trailing")):
        j = _run_jax(op, ops64, "correct", [f], N)
        assert j["dets"]
        for la in (0, 1, 2):
            _same(j, _run_torch(op, ops64, "correct", [f], N, la=la))


# ---------------------------------------------------------------------------
# policies, escalation, drivers, counters
# ---------------------------------------------------------------------------


def test_detect_policy_failstops(ops64):
    f = _seeded(51, "potrf", N // NB, "panel")
    j = _run_jax("potrf", ops64, "detect", [f], N)
    t = _run_torch("potrf", ops64, "detect", [f], N)
    assert t["error"] == ("potrf", "corruption detected (policy=detect)")
    _same(j, t)


def test_recompute_policy_skips_algebra(ops64):
    f = _seeded(52, "potrf", N // NB, "panel")
    j = _run_jax("potrf", ops64, "recompute", [f], N)
    t = _run_torch("potrf", ops64, "recompute", [f], N)
    assert t["action"] == "recomputed" and t["info"] == 0
    _same(j, t)


@pytest.mark.parametrize("persist", [True, False])
def test_double_fault(ops64, persist):
    faults = [_seeded(61, "potrf", N // NB, "trailing", persist=persist),
              _seeded(62, "potrf", N // NB, "trailing", persist=persist)]
    j = _run_jax("potrf", ops64, "correct", faults, N)
    t = _run_torch("potrf", ops64, "correct", faults, N)
    if persist:  # re-injected on the rerun: FtError, uncorrectable counted
        assert t["error"] == ("potrf", "recompute still fails verification")
        assert t["delta"]["uncorrectable"] == 1
    else:  # one-shot: the recompute runs clean
        assert t["action"] == "recomputed" and t["info"] == 0
    _same(j, t)


def test_persistent_lu_double_fault_raises(ops64):
    # the smoke's scenario 5: mild scale faults keep the elimination finite,
    # so the checksum path (not info) must catch them
    faults = [dict(op="getrf_nopiv", k=1, phase="trailing", ti=4, tj=5, r=0, c=1, mode=2,
                   value=3.0, persist=True),
              dict(op="getrf_nopiv", k=2, phase="trailing", ti=6, tj=4, r=0, c=0, mode=2,
                   value=3.0, persist=True)]
    j = _run_jax("getrf_nopiv", ops64, "correct", faults, N)
    t = _run_torch("getrf_nopiv", ops64, "correct", faults, N)
    assert "error" in t and t["dets"]
    _same(j, t)


def test_driver_opts_routing(ops64):
    """Option.FaultTolerance through the mesh drivers: a corrected gemm, an
    FT posv (f64 under MixedPrecision off, and under the default mixed
    ladder, whose f32 factor is then checksummed) and an FT LU solve, each
    against slate_tpu's."""
    jm, tm = _jmesh(), _tmesh()
    f = _seeded(71, "gemm", N // NB, "trailing")
    with jscope(JPlan([jinject.Fault(**f)])):
        cj = jdrv.gemm_mesh(1.0, jnp.asarray(ops64["a"]), jnp.asarray(ops64["b"]), jm, NB,
                            opts={JOption.FaultTolerance: "correct"})
    before = tcounters()
    with tscope(TPlan([tinject.Fault(**f)])):
        ct = tp.gemm_mesh(1.0, _t(ops64["a"]), _t(ops64["b"]), tm, NB,
                          opts={TOption.FaultTolerance: "correct"})
    assert _delta(before, tcounters())["corrected"] > 0
    ref = ops64["a"] @ ops64["b"]
    assert np.abs(ct.numpy() - ref).max() < 1e-12 * np.abs(ref).max()
    assert np.abs(ct.numpy() - np.asarray(cj)).max() < 1e-12 * np.abs(ref).max()
    xt = np.random.default_rng(5).standard_normal((N, 3))
    rhs = ops64["spd"] @ xt
    for pol in ("correct", TPolicy.Correct):
        x, info = tp.posv_mesh(_t(ops64["spd"]), _t(rhs), tm, NB,
                               opts={TOption.FaultTolerance: pol, TOption.MixedPrecision: "off"})
        assert int(info) == 0 and np.abs(x.numpy() - xt).max() < 1e-9
    xj, _ = jdrv.posv_mesh(jnp.asarray(ops64["spd"]), jnp.asarray(rhs), jm, NB,
                           opts={JOption.FaultTolerance: "correct", JOption.MixedPrecision: "off"})
    assert np.abs(x.numpy() - np.asarray(xj)).max() < 1e-12 * np.abs(xt).max()
    x, info = tp.posv_mesh(_t(ops64["spd"]), _t(rhs), tm, NB,
                           opts={TOption.FaultTolerance: "correct"})  # the mixed ladder
    assert int(info) == 0 and np.abs(x.numpy() - xt).max() < 1e-9
    lu, info = tp.getrf_nopiv_mesh(_t(ops64["dd"]), tm, NB, opts={TOption.FaultTolerance: "detect"})
    assert int(info) == 0
    x, info = tp.gesv_nopiv_mesh(_t(ops64["dd"]), _t(rhs), tm, NB,
                                 opts={TOption.FaultTolerance: "correct"})
    xj, _ = jdrv.gesv_nopiv_mesh(jnp.asarray(ops64["dd"]), jnp.asarray(rhs), jm, NB,
                                 opts={JOption.FaultTolerance: "correct"})
    assert int(info) == 0
    assert np.abs(x.numpy() - np.asarray(xj)).max() < 1e-12 * np.abs(np.asarray(xj)).max()


@pytest.mark.parametrize("pol", ["detect", "correct", "recompute"])
def test_api_multiply_ft(pol):
    rng = np.random.default_rng(9)
    a, b, c = rng.standard_normal((48, 40)), rng.standard_normal((40, 24)), rng.standard_normal((48, 24))
    ref = 2.0 * a @ b + 0.5 * c
    out = tapi.multiply(2.0, _t(a), _t(b), 0.5, _t(c), opts={TOption.FaultTolerance: pol})
    outj = japi.multiply(2.0, jnp.asarray(a), jnp.asarray(b), 0.5, jnp.asarray(c),
                         opts={JOption.FaultTolerance: pol})
    assert np.abs(out.numpy() - ref).max() < 1e-12 * np.abs(ref).max()
    assert np.abs(out.numpy() - np.asarray(outj)).max() < 1e-12 * np.abs(ref).max()
    # Option.BlockSize sets the checksum tiles; FT off is the plain gemm
    out16 = tapi.multiply(2.0, _t(a), _t(b), 0.5, _t(c),
                          opts={TOption.FaultTolerance: pol, TOption.BlockSize: 16})
    plain = tapi.multiply(2.0, _t(a), _t(b), 0.5, _t(c))
    assert np.abs(out16.numpy() - ref).max() < 1e-12 * np.abs(ref).max()
    assert np.abs(plain.numpy() - ref).max() < 1e-12 * np.abs(ref).max()


def test_non_spd_keeps_info_semantics():
    """A legitimately non-SPD input breaks down (info != 0): one rerun, the
    plain driver's info, never FtError, no fault claimed — as slate_tpu."""
    bad = -np.eye(32)
    jm, tm = _jmesh(), _tmesh()
    for pol in ("correct", "detect"):
        before_j, before_t = jcounters(), tcounters()
        lj, ij, rj = jabft.potrf_ft(jnp.asarray(bad), jm, 8, policy=JPolicy(pol))
        lt, it, rt = tabft.potrf_ft(_t(bad), tm, 8, policy=TPolicy(pol))
        assert int(it) == int(ij) != 0 and rt.action == rj.action == "clean"
        assert _delta(before_t, tcounters()) == _delta(before_j, jcounters())
        assert _delta(before_t, tcounters())["uncorrectable"] == 0


def test_trsm_detect_correct_recompute(ops64):
    """The solution-checksum carrier: clean, a corrupted already-solved X
    tile (corrected), a corrupted not-yet-solved one (recomputed), and
    detect's fail-stop — each with slate_tpu's action, detections and
    counter deltas, and X to 1e-10 of the solve."""
    rng = np.random.default_rng(13)
    tl = np.tril(rng.standard_normal((N, N))) + N * np.eye(N)
    b = rng.standard_normal((N, 2 * NB))
    ref = np.linalg.solve(tl, b)
    nt = N // NB
    cases = [
        ("correct", []),
        ("correct", [dict(op="trsm", k=nt - 1, phase="trailing", ti=1, tj=0, r=1, c=0, mode=2,
                          value=3.0, persist=False)]),
        ("correct", [dict(op="trsm", k=1, phase="trailing", ti=5, tj=1, r=1, c=1, mode=2,
                          value=3.0, persist=False)]),
        ("correct", [dict(op="trsm", k=2, phase="bcast", ti=6, tj=2, r=0, c=1, mode=3,
                          value=1e3, persist=False)]),
        ("detect", [dict(op="trsm", k=nt - 1, phase="trailing", ti=2, tj=0, r=0, c=0, mode=2,
                         value=2.0, persist=False)]),
    ]
    actions = []
    for pol, faults in cases:
        res = {}
        for side, mesh, ab, pkg in (("jax", _jmesh(), jnp.asarray, (jabft, jinject, JPlan, jscope,
                                                                     JPolicy, JFtError, jcounters)),
                                    ("torch", _tmesh(), _t, (tabft, tinject, TPlan, tscope,
                                                             TPolicy, TFtError, tcounters))):
            abft, inj, plan, scope, policy, err, counters = pkg
            before = counters()
            out = {}
            try:
                with scope(plan([inj.Fault(**f) for f in faults])):
                    x, rep = abft.trsm_ft(ab(tl), ab(b), mesh, NB, policy=policy(pol))
                out["action"], out["dets"], out["x"] = rep.action, rep.detections, _np(x)
            except err as e:
                out["error"], out["dets"] = e.op, e.detections
            out["delta"] = _delta(before, counters())
            res[side] = out
        j, t = res["jax"], res["torch"]
        assert t.get("action") == j.get("action") and t.get("error") == j.get("error")
        assert _dets(t["dets"]) == _dets(j["dets"]) and t["delta"] == j["delta"]
        np.testing.assert_allclose(_mags(t["dets"]), _mags(j["dets"]), rtol=1e-8)
        if "x" in t:
            assert np.abs(t["x"] - ref).max() / np.abs(ref).max() < 1e-10
        actions.append(t.get("action", t.get("error")))
    assert actions[:3] == ["clean", "corrected", "recomputed"] and actions[4] == "trsm"


def test_ft_smoke_on_the_host():
    """``python -m slate_tpu_torch.ft.smoke --device cpu``: the seven
    scenarios of slate_tpu's smoke all pass, and the counters clear the
    smoke's bounds (slate_tpu's floors)."""
    from slate_tpu_torch.ft import smoke

    res = smoke.run_smoke("cpu")
    assert res["ok"], res["scenarios"]
    assert set(res["scenarios"]) == {"gemm", "potrf", "getrf_nopiv", "recompute", "double_fault",
                                     "trsm", "her2k", "counters"}
    c = res["counters"]
    assert c["detected"] >= 7 and c["corrected"] >= 5 and c["recomputed"] >= 1
    assert c["uncorrectable"] >= 1


# ---------------------------------------------------------------------------
# complex operands: the checksum ramps, the verify and the repairs in c64 and
# c128 (the ramp weights are made in the real dtype and cast; torch has no
# complex arange)
# ---------------------------------------------------------------------------


def _complex_operands(n, dtype, seed=7):
    """randn + i randn A and B, a Hermitian positive definite G G^H + n I
    and a diagonally dominant randn + i randn + n I."""
    rng = np.random.default_rng(seed)

    def c(shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    a, b, g, d = c((n, n)), c((n, n)), c((n, n)), c((n, n))
    ops = {"a": a, "b": b, "spd": g @ g.conj().T + n * np.eye(n), "dd": d + n * np.eye(n)}
    return {k: v.astype(dtype) for k, v in ops.items()}


# one fault per op that slate_tpu detects at n = 64 in c128 (as in the
# ragged parity cases)
COMPLEX_FAULTS = {"gemm": (21, "trailing"), "potrf": (31, "panel"), "getrf_nopiv": (43, "trailing")}
COMPLEX_CASES = [(op, pol, faulty) for op in COMPLEX_FAULTS for pol in ("detect", "correct")
                 for faulty in (False, True)]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("op,pol,faulty", COMPLEX_CASES,
                         ids=[f"{o}-{p}-{'fault' if f else 'clean'}" for o, p, f in COMPLEX_CASES])
def test_complex_fault_parity(op, pol, faulty, dtype):
    """Complex FaultTolerance: the same action (or FtError), detections'
    kind/where, counter deltas and info as slate_tpu; magnitudes to rtol
    1e-8 (c128) / 1e-3 (c64), the result to 1e-12 (c128) / n eps32 (c64)
    of max|ref|."""
    ops = _complex_operands(N, dtype)
    seed, phase = COMPLEX_FAULTS[op]
    faults = [_seeded(seed, op, N // NB, phase)] if faulty else []
    j = _run_jax(op, ops, pol, faults, N)
    t = _run_torch(op, ops, pol, faults, N)
    assert t.get("error") == j.get("error") and t.get("action") == j.get("action")
    assert _dets(t["dets"]) == _dets(j["dets"])
    c128 = dtype == np.complex128
    np.testing.assert_allclose(_mags(t["dets"]), _mags(j["dets"]), rtol=1e-8 if c128 else 1e-3)
    assert t["delta"] == j["delta"] and t.get("info") == j.get("info")
    if "result" in j:
        scale = np.abs(j["result"]).max()
        tol = 1e-12 if c128 else N * np.finfo(np.float32).eps
        assert np.abs(t["result"] - j["result"]).max() <= tol * scale
    if not faulty:
        assert j.get("action") == "clean" and not j["dets"]
    elif c128:
        assert j["dets"]  # the seeded fault is seen in c128


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_ft_drivers_match_jax(dtype):
    """gemm_mesh (one seeded trailing fault), posv_mesh and
    gesv_nopiv_mesh under FaultTolerance detect and correct on complex
    operands: the port's results are slate_tpu's, to 1e-12 (c128) /
    n eps32 (c64) of their scale, with the same counter deltas."""
    ops = _complex_operands(N, dtype, seed=8)
    tol = 1e-12 if dtype == np.complex128 else N * np.finfo(np.float32).eps
    rhs = ops["b"][:, :3]
    jm, tm = _jmesh(), _tmesh()
    f = _seeded(21, "gemm", N // NB, "trailing")
    for pol in ("detect", "correct"):
        jo = {JOption.FaultTolerance: pol, JOption.MixedPrecision: "off"}
        to = {TOption.FaultTolerance: pol, TOption.MixedPrecision: "off"}
        res = {}
        for side in ("jax", "torch"):
            counters = jcounters if side == "jax" else tcounters
            before = counters()
            out = {}
            try:
                if side == "jax":
                    with jscope(JPlan([jinject.Fault(**f)])):
                        out["gemm"] = np.asarray(jdrv.gemm_mesh(
                            1.0, jnp.asarray(ops["a"]), jnp.asarray(ops["b"]), jm, NB, opts=jo))
                else:
                    with tscope(TPlan([tinject.Fault(**f)])):
                        out["gemm"] = tp.gemm_mesh(1.0, _t(ops["a"]), _t(ops["b"]), tm, NB,
                                                   opts=to).numpy()
            except (JFtError, TFtError) as e:
                out["gemm_error"] = e.op
            if side == "jax":
                x, info = jdrv.posv_mesh(jnp.asarray(ops["spd"]), jnp.asarray(rhs), jm, NB, opts=jo)
                y, info2 = jdrv.gesv_nopiv_mesh(jnp.asarray(ops["dd"]), jnp.asarray(rhs), jm, NB,
                                                opts=jo)
            else:
                x, info = tp.posv_mesh(_t(ops["spd"]), _t(rhs), tm, NB, opts=to)
                y, info2 = tp.gesv_nopiv_mesh(_t(ops["dd"]), _t(rhs), tm, NB, opts=to)
            out.update(posv=_np(x), gesv=_np(y), info=(int(info), int(info2)))
            out["delta"] = _delta(before, counters())
            res[side] = out
        j, t = res["jax"], res["torch"]
        assert t.get("gemm_error") == j.get("gemm_error")
        assert t["info"] == j["info"] == (0, 0) and t["delta"] == j["delta"]
        for key in ("gemm", "posv", "gesv"):
            if key in j:
                scale = np.abs(j[key]).max()
                assert np.abs(t[key] - j[key]).max() <= tol * scale, (pol, key)
