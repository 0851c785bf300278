"""The port's numerics gauges (slate_tpu_torch.obs.numerics, Option.NumMonitor
in the mesh k-loops and condest) against slate_tpu's on the same numpy
inputs.

One shape for the file: n = 48, nb = 8 on 2 x 4 (6 tile steps padded to
8: the pad rows and columns are masked out of every gauge), f64; the
monitored slate_tpu kernels are compiled once each.  Stated tolerances:

- closed-form gauges exactly: the Wilkinson growth 2^(n-1) (partial
  pivoting and no pivoting), ``spd_neardiag``'s margin 1/cond = 1e-8 and
  diagonal minimum 1e-4;
- the other gauges within the factors' f64 class, 100 n eps64 relative
  (the two packages' arithmetic differs in summation order);
- routing decisions exactly (tests/test_torch_obs_numwatch.py).

Within the port, bitwise: every monitored factor against its unmonitored
run, the same kernel launches and audited bytes, and the gauges across
lookahead depths and broadcast lowerings.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu.obs import numerics as jnum
from slate_tpu.obs import span as jspan
from slate_tpu.parallel import dist_aux as jaux
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel.dist_chol import potrf_dist as jpotrf
from slate_tpu.parallel.dist_lu import getrf_nopiv_dist as jnopiv
from slate_tpu.parallel.dist_lu import getrf_pp_dist as jpp
from slate_tpu.parallel.dist_lu import getrf_tntpiv_dist as jtnt
from slate_tpu.parallel.dist_qr import geqrf_dist as jgeqrf
from slate_tpu.parallel.dist_twostage import he2hb_dist as jhe2hb
from slate_tpu.types import Norm as JNorm
from slate_tpu.utils.testing import generate
from slate_tpu_torch import obs
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.obs import numerics as tnum
from slate_tpu_torch.ops import kernels
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dist_aux as taux
from slate_tpu_torch.types import Norm

torch.set_num_threads(1)

N, NB = 48, 8
EPS = float(np.finfo(np.float64).eps)
REL = 100 * N * EPS


@pytest.fixture(scope="module", autouse=True)
def _x64_and_release():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in ("SLATE_TPU_OBS", tnum.NUM_ENV, "SLATE_TPU_PANEL_IMPL", "SLATE_TPU_UPDATE_IMPL",
                "SLATE_TPU_BCAST_IMPL"):
        monkeypatch.delenv(env, raising=False)
    tnum.reset()
    jnum.reset()


def _jmesh():
    return jmake_mesh(2, 4, devices=cpu_devices(8))


def _tmesh():
    return tp.make_mesh(2, 4, device="cpu")


def _j(a, pad=True):
    return jfrom_dense(jnp.asarray(a), _jmesh(), NB, diag_pad_one=pad)


def _t(a, pad=True):
    return tp.from_dense(torch.from_numpy(np.ascontiguousarray(a)), _tmesh(), NB, diag_pad_one=pad)


def _close(got: dict, want: dict, exact=()):
    assert set(got) == set(want), (got, want)
    for k, w in want.items():
        if k in exact:
            assert got[k] == w, (k, got[k], w)
        else:
            assert abs(got[k] - w) <= REL * max(abs(w), 1e-300), (k, got[k], w)


def _counts():
    return {k: getattr(kernels, k).launches for k in ("chol_panel_tiles", "chol_trailing_update",
                                                      "lu_panel_tiles", "lu_rowsolve_tiles",
                                                      "lu_trailing_update", "qr_panel_offset")}


def _bitwise(x, y):
    if isinstance(x, torch.Tensor):
        assert torch.equal(x, y)
    elif isinstance(x, tp.DistMatrix):
        assert torch.equal(x.tiles, y.tiles)
    else:
        for a, b in zip(x, y):
            _bitwise(a, b)


def _on_off(fn):
    """(monitored result, its audited bytes) after asserting it bitwise the
    unmonitored run, with the same launches and audited bytes."""
    runs = {}
    for mode in ("off", "on"):
        before = _counts()
        with tcomm.comm_audit() as recs:
            out = fn(mode)
        after = _counts()
        runs[mode] = (out, sum(nb * m for _, nb, m in recs),
                      {k: after[k] - before[k] for k in after})
    _bitwise(runs["on"][0], runs["off"][0])
    assert runs["on"][1:] == runs["off"][1:]
    return runs["on"][0]


# ---------------------------------------------------------------------------
# Option.NumMonitor resolution
# ---------------------------------------------------------------------------


def test_resolve_num_monitor_precedence(monkeypatch):
    """explicit > use_num_monitor > SLATE_TPU_NUM > auto (on iff obs is
    enabled), decided as slate_tpu decides, and its ValueError."""
    cases = []
    for env in (None, "on", "off", "auto"):
        for ctx in (None, "on", "off"):
            for explicit in (None, "on", "off", "auto"):
                for enabled in (False, True):
                    cases.append((env, ctx, explicit, enabled))
    for env, ctx, explicit, enabled in cases:
        for num, span in ((tnum, obs), (jnum, jspan)):
            if env is None:
                monkeypatch.delenv(num.NUM_ENV, raising=False)
            else:
                monkeypatch.setenv(num.NUM_ENV, env)
        with obs.force_enabled(enabled), jspan.force_enabled(enabled):
            if ctx is None:
                got, want = tnum.resolve_num_monitor(explicit), jnum.resolve_num_monitor(explicit)
            else:
                with tnum.use_num_monitor(ctx), jnum.use_num_monitor(ctx):
                    got = tnum.resolve_num_monitor(explicit)
                    want = jnum.resolve_num_monitor(explicit)
        assert got == want, (env, ctx, explicit, enabled)
    with pytest.raises(ValueError, match="num-monitor"):
        tnum.resolve_num_monitor("loud")
    assert (tnum.GROWTH_THRESHOLD, tnum.CONDEST_THRESHOLD, tnum.ORTH_THRESHOLD) == \
        (jnum.GROWTH_THRESHOLD, jnum.CONDEST_THRESHOLD, jnum.ORTH_THRESHOLD)
    assert tnum.NUM_MODES == jnum.NUM_MODES and tnum.num_counter_values().keys() == \
        jnum.num_counter_values().keys()


def test_auto_follows_obs_and_records_nothing_when_off():
    """NumMonitor auto: off with obs off (no gauge, nothing counted), on
    with obs on (gauges, the num section counts the run)."""
    a = generate("spd", N, seed=3)
    tp.potrf_dist(_t(a))
    assert tnum.last_gauges("potrf") == {} and tnum.num_counter_values()["monitored"] == 0
    with obs.force_enabled():
        tp.potrf_dist(_t(a))
    assert set(tnum.last_gauges("potrf")) == {"margin", "diag_min", "diag_max"}
    assert tnum.num_counter_values()["monitored"] == 1


# ---------------------------------------------------------------------------
# the gauges against slate_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["spd_neardiag", "spd"])
def test_potrf_gauges_match_jax(kind):
    a = generate(kind, N, seed=4, cond=1e8)
    jpotrf(_j(a), num_monitor="on")
    want = jnum.last_gauges("potrf")
    _on_off(lambda m: tp.potrf_dist(_t(a), num_monitor=m))
    got = tnum.last_gauges("potrf")
    _close(got, want, exact=("margin", "diag_min") if kind == "spd_neardiag" else ())
    if kind == "spd_neardiag":
        assert got["margin"] == 1e-8 and got["diag_min"] == 1e-4


def test_lu_growth_match_jax():
    """Wilkinson through pp and nopiv: 2^(n-1) exactly in both packages;
    tournament pivoting and a dominant matrix in the f64 class."""
    w = generate("wilkinson", N)
    d = generate("dominant", N, seed=1)
    jpp(_j(w), num_monitor="on")
    jnopiv(_j(w), num_monitor="on")
    jtnt(_j(d), num_monitor="on")
    want = {op: jnum.last_gauges(op) for op in ("getrf_pp", "getrf_nopiv", "getrf_tntpiv")}
    _on_off(lambda m: tp.getrf_pp_dist(_t(w), num_monitor=m))
    _on_off(lambda m: tp.getrf_nopiv_dist(_t(w), num_monitor=m))
    _on_off(lambda m: tp.getrf_tntpiv_dist(_t(d), num_monitor=m))
    for op in want:
        _close(tnum.last_gauges(op), want[op],
               exact=("amax", "gmax", "growth") if op != "getrf_tntpiv" else ())
    assert tnum.last_gauges("getrf_pp")["growth"] == 2.0 ** (N - 1)
    assert tnum.last_gauges("getrf_nopiv")["growth"] == 2.0 ** (N - 1)
    assert tnum.num_counter_values()["growth_alarms"] == 2


def test_qr_and_he2hb_orth_match_jax():
    """The orthogonality gauges in slate_tpu's eps class: both in (0,
    1e-12) for these panels, each within 100x of slate_tpu's (a rounding
    residual: the packages' Householder arithmetic differs in order)."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((N, N))
    s = generate("spd", N, seed=11)
    jgeqrf(_j(a, pad=False), num_monitor="on")
    jhe2hb(_j(s, pad=False), num_monitor="on")
    _on_off(lambda m: tp.geqrf_dist(_t(a, pad=False), num_monitor=m))
    _on_off(lambda m: tp.he2hb_dist(_t(s, pad=False), num_monitor=m))
    for op, key in (("geqrf", "qr_orth_loss"), ("he2hb", "he2hb_orth_loss")):
        got, want = tnum.last_gauges(op)[key], jnum.last_gauges(op)[key]
        assert 0 < got < 1e-12 and 0 < want < 1e-12, (op, got, want)
        assert want / 100 <= got <= want * 100, (op, got, want)
    assert not tnum.orth_exceeded("geqrf") and not tnum.orth_exceeded("he2hb")


def test_condest_gauge_match_jax():
    """gecondest_dist / pocondest_dist record num.condest (the condition
    number 1 / rcond), within the f64 class of slate_tpu's, memo hits
    included."""
    g = generate("svd", N, seed=2, cond=1e6)
    s = generate("spd_svd", N, seed=5, cond=1e5)
    jlu, jperm, _ = jpp(_j(g))
    jaux.gecondest_dist(jlu, jperm, jaux.norm_dist(JNorm.One, _j(g, pad=False)))
    jl, _ = jpotrf(_j(s))
    jaux.pocondest_dist(jl, jaux.norm_dist(JNorm.One, _j(s, pad=False)))
    lu, perm, _ = tp.getrf_pp_dist(_t(g))
    anorm = taux.norm_dist(Norm.One, _t(g, pad=False))
    rc = taux.gecondest_dist(lu, perm, anorm)
    assert taux.gecondest_dist(lu, perm, anorm) is rc  # the memo, recorded again
    ll, _ = tp.potrf_dist(_t(s))
    taux.pocondest_dist(ll, taux.norm_dist(Norm.One, _t(s, pad=False)))
    for op in ("gesv", "posv"):
        _close(tnum.last_gauges(op), jnum.last_gauges(op))
    assert tnum.num_counter_values()["condest_solves"] == 3


# ---------------------------------------------------------------------------
# within the port: depth, lowering and flight
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["potrf", "getrf_nopiv"])
def test_gauges_bitwise_across_depths_and_bcast(op):
    a = generate("spd_neardiag" if op == "potrf" else "dominant", N, seed=4, cond=1e8)
    drv = tp.potrf_dist if op == "potrf" else tp.getrf_nopiv_dist
    seen = set()
    for la in (0, 1, 2):
        for bi in ("psum", "ring", "doubling"):
            drv(_t(a), lookahead=la, bcast_impl=bi, num_monitor="on")
            seen.add(tuple(sorted(tnum.last_gauges(op).items())))
    assert len(seen) == 1, seen


def test_pp_gauges_follow_slate_tpus_sampling():
    """The partial-pivot gauge samples the stack at each step's entry,
    before a deferred update lands, as slate_tpu's does, so at lookahead 1
    it can read less than at depth 0 (4.30 against 3.86 here, in both
    packages).  At each depth: within the f64 class of slate_tpu's at the
    same depth, and bitwise across the lowerings."""
    a = generate("svd", N, seed=2, cond=1e6)
    for la in (0, 1):
        jpp(_j(a), lookahead=la, num_monitor="on")
        seen = set()
        for bi in ("psum", "ring"):
            tp.getrf_pp_dist(_t(a), lookahead=la, bcast_impl=bi, num_monitor="on")
            seen.add(tuple(sorted(tnum.last_gauges("getrf_pp").items())))
        assert len(seen) == 1, seen
        _close(tnum.last_gauges("getrf_pp"), jnum.last_gauges("getrf_pp"), exact=("amax",))


def test_flight_step_dispatch_records_no_gauge():
    """Under the flight recorder the loops record no gauge (slate_tpu's
    per-phase programs carry none); the factor is the same bits."""
    from slate_tpu_torch.obs import flight

    a = generate("spd", N, seed=3)
    ref = tp.potrf_dist(_t(a))
    with flight.flight_scope():
        got = tp.potrf_dist(_t(a), num_monitor="on")
    _bitwise(got, ref)
    assert tnum.last_gauges("potrf") == {} and tnum.num_counter_values()["monitored"] == 0


def test_recording_surface_matches_jax():
    """record_* on the same scalars: the same last gauges, num section and
    routing decisions (route_entry_tier) in both packages."""
    for mod in (tnum, jnum):
        mod.reset()
        mod.record_lu_growth("getrf_pp", 2.0, 2.0 ** 30)
        mod.record_chol_gauges("potrf", 1e-9, 1e-3, 2.0)
        mod.record_qr_orth("geqrf", 1e-6)
        mod.record_condest("gesv", 1e-9)
        mod.record_routed_gmres("gesv")
        mod.record_ir_history("gesv", np.array([[1.0, 2.0], [0.5, 2.0], [np.nan, np.nan]]), 1)
    for op in ("getrf_pp", "potrf", "geqrf", "gesv"):
        assert tnum.last_gauges(op) == jnum.last_gauges(op)
    assert tnum.num_counter_values() == jnum.num_counter_values()
    assert tnum.last_history("gesv") == jnum.last_history("gesv") == [(1.0, 2.0), (0.5, 2.0)]
    assert tnum.orth_exceeded("geqrf") == jnum.orth_exceeded("geqrf") is True
    for gauges, rcond in (({"growth": 2.0 ** 21}, None), ({}, 1e-8), ({}, 1e-6),
                          ({"margin": 1e-9, "diag_max": 1.0}, None),
                          ({"margin": 1e-3, "diag_max": 1.0}, 1e-3)):
        assert tnum.route_entry_tier("gesv", gauges, rcond) == \
            jnum.route_entry_tier("gesv", gauges, rcond)
    with pytest.raises(tnum.GrowthAbort, match="GROWTH_THRESHOLD"):
        raise tnum.GrowthAbort("getrf_nopiv", 2.0 ** 24, 4, tnum.GROWTH_THRESHOLD)
