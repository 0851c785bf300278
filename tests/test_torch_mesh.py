"""The port's mesh solve (slate_tpu_torch.parallel) against slate_tpu.parallel.

The same seeded numpy operands go through ``slate_tpu``'s mesh drivers on
the 8 forced CPU devices of conftest.py (a 2 x 4 mesh, the Pallas panel and
update kernels interpreted under PanelImpl/UpdateImpl ``pallas``) and
through the port's drivers on a virtual 2 x 4 mesh on the CPU, where the
kernel wrappers take their plain twins.  Shapes are the dryrun's (n = 64,
nb = 8, 16 right-hand sides) plus a padded n = 100.

Bitwise: the cyclic index maps, from_dense/to_dense, the hop schedules, the
audited comm bytes, info codes, and the port's own lookahead and
broadcast-lowering invariance.  Elementwise results hold to 100 n eps
scaled by the operands (two frameworks, two summation orders; the Cholesky
panels are explicit-inverse on both sides).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import types as jt
from slate_tpu.core import grid as jgrid
from slate_tpu.core import tiling as jtiling
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import gemm_summa as jgemm_summa
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import potrf_dist as jpotrf_dist
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu.parallel import trsm_dist as jtrsm_dist
from slate_tpu.utils.testing import generate
from slate_tpu_torch import types as tt
from slate_tpu_torch.core import grid as tgrid
from slate_tpu_torch.core import tiling as ttiling
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dryrun as tdry
from slate_tpu_torch.parallel import (
    from_dense,
    gemm_summa,
    make_mesh,
    potrf_dist,
    to_dense,
    trsm_dist,
)

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

NB = 8
DTYPES = [np.float32, np.float64]
SIZES = [64, 100]  # 100: a padded tile grid (13 tiles -> 16)
IMPLS = ["psum", "ring", "doubling"]


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _tol(n, dtype, scale=1.0):
    # two frameworks, two summation orders, explicit-inverse panels on both
    # sides: the O(n eps) class, scaled by the operands' magnitude
    return 100 * n * _eps(dtype) * scale


def _jmesh():
    return jmake_mesh(2, 4, devices=cpu_devices(8))


def _tmesh():
    return make_mesh(2, 4, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(n, dtype, nrhs=16):
    a = generate("spd", n, dtype=dtype, seed=n)
    b = generate("randn", n, nrhs, dtype=dtype, seed=n + 1)
    return a, b


@pytest.fixture(autouse=True)
def _default_impls(monkeypatch):
    for env in (tk.PANEL_IMPL_ENV, tk.UPDATE_IMPL_ENV, tcomm.BCAST_IMPL_ENV):
        monkeypatch.delenv(env, raising=False)


# ---------------------------------------------------------------------------
# JAX references, computed once per configuration
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_chain(n, dtype_name, bcast_impl="auto"):
    """slate_tpu's posv_chain pieces, pallas panels and updates."""
    dtype = np.dtype(dtype_name).type
    a, b = _operands(n, dtype)
    mesh = _jmesh()
    ad = jfrom_dense(jnp.asarray(a), mesh, NB, diag_pad_one=True)
    bd = jfrom_dense(jnp.asarray(b), mesh, NB)
    l, info = jpotrf_dist(ad, bcast_impl=bcast_impl, panel_impl="pallas",
                          update_impl="pallas", num_monitor="off")
    y = jtrsm_dist(l, bd, jt.Uplo.Lower, jt.Op.NoTrans, jt.Diag.NonUnit, bcast_impl=bcast_impl)
    x = jtrsm_dist(l, y, jt.Uplo.Lower, jt.Op.ConjTrans, jt.Diag.NonUnit, bcast_impl=bcast_impl)
    ax = jgemm_summa(1.0, jfrom_dense(jnp.asarray(a), mesh, NB), x, bcast_impl=bcast_impl,
                     update_impl="pallas")
    return {"l": np.asarray(jto_dense(l)), "info": int(info), "y": np.asarray(jto_dense(y)),
            "x": np.asarray(jto_dense(x)), "ax": np.asarray(jto_dense(ax))}


def _port_chain(n, dtype, **opts):
    a, b = _operands(n, dtype)
    mesh = _tmesh()
    ad = from_dense(_t(a), mesh, NB, diag_pad_one=True)
    bd = from_dense(_t(b), mesh, NB)
    solve = {k: v for k, v in opts.items() if k in ("lookahead", "bcast_impl")}
    l, info = potrf_dist(ad, **opts)
    y = trsm_dist(l, bd, tt.Uplo.Lower, tt.Op.NoTrans, tt.Diag.NonUnit, **solve)
    x = trsm_dist(l, y, tt.Uplo.Lower, tt.Op.ConjTrans, tt.Diag.NonUnit, **solve)
    gopts = {k: v for k, v in opts.items() if k != "panel_impl"}
    ax = gemm_summa(1.0, from_dense(_t(a), mesh, NB), x, **gopts)
    return {"l": to_dense(l).numpy(), "info": int(info), "y": to_dense(y).numpy(),
            "x": to_dense(x).numpy(), "ax": to_dense(ax).numpy()}


# ---------------------------------------------------------------------------
# comm audit: bytes per op equal to slate_tpu's, under every lowering
# (first in the module; a unique shape, so slate_tpu traces afresh)
# ---------------------------------------------------------------------------


def _totals(records):
    out = {}
    for op, nbytes, mult in records:
        out[op] = out.get(op, 0) + nbytes * mult
    return out


@pytest.mark.parametrize("impl,n", [("psum", 40), ("ring", 56), ("doubling", 72)])
def test_posv_chain_audit_bytes_match_jax(impl, n):
    # slate_tpu records at trace time and some of its kernels do not key
    # their jit cache on the lowering: one tile grid per lowering (12, 16,
    # 20 tiles at nb = 4), shapes no other test compiles
    nb, nrhs = 4, 6
    a, b = _operands(n, np.float32, nrhs)
    mt = (-(-n // nb) + 3) // 4 * 4  # tiles padded to lcm(2, 4)
    sel_trsm = jt.select_trsm_method(jt.Side.Left, mt, 4).name
    other_trsm = "TrsmB" if sel_trsm == "TrsmA" else "TrsmA"
    other_gemm = "GemmC" if jt.select_gemm_method(mt, 4, mt).name == "GemmA" else "GemmA"
    mesh = _jmesh()
    with jcomm.comm_audit() as jrec:
        ad = jfrom_dense(jnp.asarray(a), mesh, nb, diag_pad_one=True)
        bd = jfrom_dense(jnp.asarray(b), mesh, nb)
        l, _ = jpotrf_dist(ad, bcast_impl=impl, num_monitor="off")
        y = jtrsm_dist(l, bd, jt.Uplo.Lower, jt.Op.NoTrans, jt.Diag.NonUnit, bcast_impl=impl)
        x = jtrsm_dist(l, y, jt.Uplo.Lower, jt.Op.ConjTrans, jt.Diag.NonUnit, bcast_impl=impl)
        jgemm_summa(1.0, ad, x, bcast_impl=impl)
        # and the schedules the chain did not select (a jit cache hit on a
        # selected one would record nothing)
        jgemm_summa(1.0, ad, bd, bcast_impl=impl, method=jt.MethodGemm[other_gemm])
        for op in ("NoTrans", "ConjTrans"):
            jtrsm_dist(l, bd, jt.Uplo.Lower, jt.Op[op], jt.Diag.NonUnit, bcast_impl=impl,
                       method=jt.MethodTrsm[other_trsm])
    tmesh = _tmesh()
    with tcomm.comm_audit() as trec:
        ad = from_dense(_t(a), tmesh, nb, diag_pad_one=True)
        bd = from_dense(_t(b), tmesh, nb)
        l, _ = potrf_dist(ad, bcast_impl=impl)
        y = trsm_dist(l, bd, tt.Uplo.Lower, tt.Op.NoTrans, tt.Diag.NonUnit, bcast_impl=impl)
        x = trsm_dist(l, y, tt.Uplo.Lower, tt.Op.ConjTrans, tt.Diag.NonUnit, bcast_impl=impl)
        gemm_summa(1.0, ad, x, bcast_impl=impl)
        gemm_summa(1.0, ad, bd, bcast_impl=impl, method=tt.MethodGemm[other_gemm])
        for op in ("NoTrans", "ConjTrans"):
            trsm_dist(l, bd, tt.Uplo.Lower, tt.Op[op], tt.Diag.NonUnit, bcast_impl=impl,
                      method=tt.MethodTrsm[other_trsm])
    jt_, tt_ = _totals(jrec), _totals(trec)
    assert jt_ and jt_ == tt_
    ops = set(jt_)
    if impl == "psum":
        assert not any(op.startswith("ppermute") for op in ops)
    else:
        assert any(op.startswith("ppermute") for op in ops)


# ---------------------------------------------------------------------------
# index maps, layout, hop schedules: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mt,p", [(8, 2), (13, 2), (16, 4), (12, 3), (5, 1)])
def test_cyclic_perm_bitwise(mt, p):
    np.testing.assert_array_equal(ttiling.cyclic_perm(mt, p), jtiling.cyclic_perm(mt, p))
    perm = jtiling.cyclic_perm(mt, p)
    np.testing.assert_array_equal(ttiling.inv_perm(perm), jtiling.inv_perm(perm))
    assert tgrid.num_tiles(mt * 7 + 3, 7) == jgrid.num_tiles(mt * 7 + 3, 7)


@pytest.mark.parametrize("mt,nt,p,q", [(8, 8, 2, 4), (6, 10, 3, 2), (5, 7, 2, 4)])
def test_to_from_cyclic_bitwise(mt, nt, p, q):
    t = np.random.default_rng(mt * nt).standard_normal((mt, nt, 3, 3))
    ref = np.asarray(jtiling.to_cyclic(jnp.asarray(t), p, q))
    got = ttiling.to_cyclic(_t(t), p, q).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ttiling.from_cyclic(_t(got), p, q).numpy(),
                                  np.asarray(jtiling.from_cyclic(jnp.asarray(ref), p, q)))
    np.testing.assert_array_equal(ttiling.from_cyclic(ttiling.to_cyclic(_t(t), p, q), p, q).numpy(), t)


@pytest.mark.parametrize("m,n", [(64, 64), (100, 100), (100, 16), (21, 37)])
@pytest.mark.parametrize("diag_pad_one", [False, True])
def test_from_dense_to_dense_bitwise(m, n, diag_pad_one):
    a = generate("randn", m, n, dtype=np.float64, seed=m + n)
    ref = jfrom_dense(jnp.asarray(a), _jmesh(), NB, diag_pad_one=diag_pad_one)
    got = from_dense(_t(a), _tmesh(), NB, diag_pad_one=diag_pad_one)
    np.testing.assert_array_equal(got.tiles.numpy(), np.asarray(ref.tiles))
    assert (got.m, got.n, got.nb, got.diag_pad) == (ref.m, ref.n, ref.nb, ref.diag_pad)
    np.testing.assert_array_equal(to_dense(got).numpy(), a)
    np.testing.assert_array_equal(to_dense(got).numpy(), np.asarray(jto_dense(ref)))


@pytest.mark.parametrize("impl", ["ring", "doubling", "auto"])
def test_bcast_hop_schedule_bitwise(impl):
    for size in range(1, 9):
        for root in range(size):
            assert tcomm.bcast_hop_schedule(impl, size, root) == jcomm.bcast_hop_schedule(impl, size, root)
    with pytest.raises(ValueError, match="psum is not a hop lowering"):
        tcomm.bcast_hop_schedule("psum", 4)


def test_loop_plans_match_jax():
    for nt in (1, 3, 8, 13, 128):
        for p, q in ((2, 4), (1, 1), (4, 2), (3, 2)):
            assert list(tcomm.bucket_plan(nt, p, q)) == list(jcomm.bucket_plan(nt, p, q))
        for la in (None, 0, 1, 2, 200):
            assert tcomm.la_depth(la, nt) == jcomm.la_depth(la, nt)


def test_method_selection_matches_jax():
    for m in (1, 4, 8, 16, 128):
        for n in (1, 4, 8, 16, 128):
            for k in (1, 8, 128):
                assert tt.select_gemm_method(m, n, k).name == jt.select_gemm_method(m, n, k).name
            for side in ("Left", "Right"):
                assert (tt.select_trsm_method(tt.Side[side], m, n).name
                        == jt.select_trsm_method(jt.Side[side], m, n).name)


def test_bcast_impl_resolution_chain(monkeypatch):
    assert tcomm.resolve_bcast_impl() == "auto"
    monkeypatch.setenv(tcomm.BCAST_IMPL_ENV, "ring")
    assert tcomm.resolve_bcast_impl() == "ring"
    with tcomm.use_bcast_impl("psum"):
        assert tcomm.resolve_bcast_impl() == "psum"
        assert tcomm.resolve_bcast_impl("doubling") == "doubling"
    with pytest.raises(ValueError, match="unknown bcast impl"):
        tcomm.resolve_bcast_impl("tree")
    with tcomm.bcast_impl_scope("auto"):
        assert tcomm._impl_for(4) == "doubling" and tcomm._impl_for(3) == "ring"
    with tcomm.bcast_impl_scope("doubling"):
        assert tcomm._impl_for(6) == "ring"


def test_virtual_collectives():
    # per-device values (P, Q, *payload) on a 2 x 3 grid
    p, q = 2, 3
    x = torch.arange(p * q * 2, dtype=torch.float64).view(p, q, 2)
    with tcomm.comm_audit() as rec:
        s = tcomm.psum_a(x, tcomm.COL_AXIS, q)
        g = tcomm.all_gather_a(x, tcomm.ROW_AXIS, p)
        # device (r, c') sends (c' + 1) x[r, i] to mesh column i
        y = x.view(p, 1, q, 2) * (torch.arange(q, dtype=x.dtype) + 1).view(1, q, 1, 1)
        ps = tcomm.psum_scatter_a(y, tcomm.COL_AXIS, q, scatter_dimension=0)
        red = tcomm.reduce_to_row(x, 1, p)
    assert s.shape == (p, 1, 2) and torch.equal(s[:, 0], x.sum(1))
    assert g.shape == (1, q, p, 2) and torch.equal(g[0].transpose(0, 1), x)
    assert ps.shape == (p, q, 2) and torch.equal(ps, x * (q * (q + 1) // 2))
    assert torch.equal(red[1], x.sum(0)) and not red[0].any()
    assert [r[0] for r in rec] == ["psum[q]", "all_gather[p]", "psum_scatter[q]", "psum[p]"]
    assert [r[1] for r in rec] == [16, 16, 48, 16]


# ---------------------------------------------------------------------------
# the drivers against slate_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_potrf_dist_matches_jax(n, dtype):
    ref = _jax_chain(n, np.dtype(dtype).name)
    got = _port_chain(n, dtype)
    a, _ = _operands(n, dtype)
    assert got["info"] == ref["info"] == 0
    assert np.abs(np.tril(got["l"]) - np.tril(ref["l"])).max() < _tol(n, dtype, np.abs(a).max())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_trsm_dist_b_and_gemm_c_match_jax(n, dtype):
    # at these shapes both packages select TrsmB and GemmC
    ref = _jax_chain(n, np.dtype(dtype).name)
    got = _port_chain(n, dtype)
    a, b = _operands(n, dtype)
    assert tt.select_trsm_method(tt.Side.Left, -(-n // NB), 4) == tt.MethodTrsm.TrsmB
    for key in ("y", "x"):
        assert np.abs(got[key] - ref[key]).max() < _tol(n, dtype, np.abs(ref[key]).max() * np.abs(a).max())
    assert np.abs(got["ax"] - ref["ax"]).max() < _tol(n, dtype, np.abs(b).max() * np.abs(a).max())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_posv_chain_eta_under_gate(n, dtype):
    ref = _jax_chain(n, np.dtype(dtype).name)
    got = _port_chain(n, dtype)
    a, b = _operands(n, dtype)
    for res in (ref, got):
        eta = np.abs(res["ax"] - b).max() / (np.abs(a).max() * np.abs(res["x"]).max() * n + np.abs(b).max())
        assert eta < 100 * n * _eps(dtype)


@functools.lru_cache(maxsize=None)
def _jax_solves(method_name, op_name, n):
    a, b = _operands(n, np.float64)
    l = np.linalg.cholesky(a)
    mesh = _jmesh()
    ld = jfrom_dense(jnp.asarray(l), mesh, NB, diag_pad_one=True)
    bd = jfrom_dense(jnp.asarray(b), mesh, NB)
    x = jtrsm_dist(ld, bd, jt.Uplo.Lower, jt.Op[op_name], jt.Diag.NonUnit,
                   method=jt.MethodTrsm[method_name])
    return l, b, np.asarray(jto_dense(x))


@pytest.mark.parametrize("method", ["TrsmA", "TrsmB"])
@pytest.mark.parametrize("op", ["NoTrans", "ConjTrans"])
@pytest.mark.parametrize("n", SIZES)
def test_trsm_dist_methods_match_jax(method, op, n):
    l, b, ref = _jax_solves(method, op, n)
    mesh = _tmesh()
    x = trsm_dist(from_dense(_t(l), mesh, NB, diag_pad_one=True), from_dense(_t(b), mesh, NB),
                  tt.Uplo.Lower, tt.Op[op], tt.Diag.NonUnit, method=tt.MethodTrsm[method])
    got = to_dense(x).numpy()
    assert np.abs(got - ref).max() < _tol(n, np.float64, np.abs(ref).max() * np.abs(l).max())
    lo = l if op == "NoTrans" else l.T
    assert np.abs(lo @ got - b).max() < _tol(n, np.float64, np.abs(l).max() * np.abs(got).max())


@pytest.mark.parametrize("method", ["GemmA", "GemmC"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_summa_methods_match_jax(method, dtype):
    m, k, n = 64, 100, 24
    a = generate("randn", m, k, dtype=dtype, seed=3)
    b = generate("randn", k, n, dtype=dtype, seed=4)
    c = generate("randn", m, n, dtype=dtype, seed=5)
    jm = _jmesh()
    ref = np.asarray(jto_dense(jgemm_summa(
        2.0, jfrom_dense(jnp.asarray(a), jm, NB), jfrom_dense(jnp.asarray(b), jm, NB), 0.5,
        jfrom_dense(jnp.asarray(c), jm, NB), method=jt.MethodGemm[method], update_impl="pallas")))
    tm = _tmesh()
    got = to_dense(gemm_summa(2.0, from_dense(_t(a), tm, NB), from_dense(_t(b), tm, NB), 0.5,
                              from_dense(_t(c), tm, NB), method=tt.MethodGemm[method])).numpy()
    assert np.abs(got - ref).max() < _tol(k, dtype, np.abs(ref).max())
    assert np.abs(got - (2.0 * a.astype(np.float64) @ b + 0.5 * c)).max() < _tol(k, dtype, np.abs(ref).max())


# ---------------------------------------------------------------------------
# info codes: bitwise equal to slate_tpu's under PanelImpl pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("j", [0, 13, 37, 63])
@pytest.mark.parametrize("dtype", DTYPES)
def test_potrf_dist_non_spd_info_matches_jax(j, dtype):
    n = 64
    a = generate("spd", n, dtype=dtype, seed=51)
    a[j, j] = -2.0
    ref = jpotrf_dist(jfrom_dense(jnp.asarray(a), _jmesh(), NB, diag_pad_one=True),
                      panel_impl="pallas", update_impl="pallas", num_monitor="off")[1]
    got = potrf_dist(from_dense(_t(a), _tmesh(), NB, diag_pad_one=True))[1]
    assert got.dtype == torch.int32
    assert int(got) == int(ref) > 0


# ---------------------------------------------------------------------------
# the port's own invariants: bitwise across lookahead and lowerings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lookahead", [0, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lookahead_invariance_bitwise(lookahead, dtype):
    base = _port_chain(100, dtype, lookahead=1)
    got = _port_chain(100, dtype, lookahead=lookahead)
    for key in ("l", "y", "x", "ax"):
        np.testing.assert_array_equal(got[key], base[key])


@pytest.mark.parametrize("impl", IMPLS)
def test_bcast_impl_invariance_bitwise(impl):
    base = _port_chain(64, np.float64, bcast_impl="auto")
    got = _port_chain(64, np.float64, bcast_impl=impl)
    for key in ("l", "y", "x", "ax"):
        np.testing.assert_array_equal(got[key], base[key])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_update_impl_on_the_host_is_the_twin(impl):
    # on a CPU tensor the wrapper and the xla form are the same plain twin
    base = _port_chain(64, np.float32)
    got = _port_chain(64, np.float32, update_impl=impl)
    for key in ("l", "x", "ax"):
        np.testing.assert_array_equal(got[key], base[key])


def test_panel_impl_xla_matches_pallas():
    pal = _port_chain(64, np.float64, panel_impl="pallas")
    xla = _port_chain(64, np.float64, panel_impl="xla")
    a, _ = _operands(64, np.float64)
    assert pal["info"] == xla["info"] == 0
    assert np.abs(np.tril(pal["l"]) - np.tril(xla["l"])).max() < _tol(64, np.float64, np.abs(a).max())


def test_num_monitor_on_is_not_ported():
    """Option.NumMonitor is ported: ``on`` factors the same bits as ``off``
    and records the margin gauges; an unknown mode raises ValueError."""
    from slate_tpu_torch.obs import numerics as tnum

    a, _ = _operands(64, np.float32)
    ad = from_dense(_t(a), _tmesh(), NB, diag_pad_one=True)
    tnum.clear_last("potrf")
    l_on, info_on = potrf_dist(ad, num_monitor="on")
    l_off, info_off = potrf_dist(ad, num_monitor="off")
    assert torch.equal(l_on.tiles, l_off.tiles) and int(info_on) == int(info_off) == 0
    assert set(tnum.last_gauges("potrf")) == {"margin", "diag_min", "diag_max"}
    with pytest.raises(ValueError, match="num-monitor"):
        potrf_dist(ad, num_monitor="bogus")
    with pytest.raises(ValueError, match="identity-padded"):
        potrf_dist(from_dense(_t(a[:60, :60]), _tmesh(), NB))


def test_potrf_dist_leaves_its_input():
    a, _ = _operands(64, np.float32)
    ad = from_dense(_t(a), _tmesh(), NB, diag_pad_one=True)
    before = ad.tiles.clone()
    potrf_dist(ad)
    assert torch.equal(ad.tiles, before)
    l, _ = potrf_dist(ad, overwrite_a=True)
    assert l.tiles.data_ptr() == ad.tiles.data_ptr()


# ---------------------------------------------------------------------------
# the port's dryrun
# ---------------------------------------------------------------------------


def test_dryrun_posv_chain_on_the_host(capsys):
    assert tdry.main(["--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    res = json.loads(line)
    assert res["ok"] and res["phases"]["posv_chain"]["eta"] < 100 * 64 * _eps(np.float32)


def test_dryrun_operands_match_the_reference():
    a, b = tdry.posv_chain_operands()
    rng = np.random.default_rng(0)
    g = rng.standard_normal((64, 64)).astype(np.float32)
    np.testing.assert_array_equal(a, g @ g.T + 64 * np.eye(64, dtype=np.float32))
    np.testing.assert_array_equal(b, rng.standard_normal((64, 16)).astype(np.float32))
