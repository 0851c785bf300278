"""The port's mesh inverses, right-side triangular solve, band multiplies
and the dryrun's hemm_summa phase against slate_tpu.parallel.

The same seeded numpy operands go through ``slate_tpu`` on the 8 forced CPU
devices (a 2 x 4 mesh) and through the port on a virtual 2 x 4 mesh on the
CPU, at a ragged n = 60 (nb = 8) in f32, f64, complex64 and complex128:
getri_mesh and potri_mesh (A X = I within 100 n eps max|A| max|X|, X within
1e-5 (f32) / 1e-12 (f64) relative of ``slate_tpu``'s, info codes bitwise
with PanelImpl pinned), trsm_dist_right (every uplo and op; lookahead and
lowering bitwise; the audited bytes equal ``slate_tpu``'s on a fresh trace),
gbmm_mesh / hbmm_mesh, and the port's dryrun with its fourth phase.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import parallel as jp
from slate_tpu import types as jt
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import dist_blas3 as jb3
from slate_tpu.parallel import dist_trsm as jtrsm
from slate_tpu_torch import types as tt
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dryrun as tdry
from slate_tpu_torch.parallel import (
    from_dense,
    gbmm_mesh,
    getri_mesh,
    hbmm_mesh,
    make_mesh,
    potri_mesh,
    to_dense,
    trsm_dist_right,
)

torch.set_num_threads(1)

NB = 8
N = 60
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def _jmesh():
    return jp.make_mesh(2, 4, devices=cpu_devices(8))


def _tmesh():
    return make_mesh(2, 4, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _rtol(dtype):
    return 1e-5 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-12


def _general(dtype, seed=1):
    return (_rand((N, N), dtype, seed) + 2 * np.sqrt(N) * np.eye(N)).astype(dtype)


def _hpd(dtype, seed=2):
    g = _rand((N, N), dtype, seed)
    return (g @ g.conj().T / N + np.eye(N)).astype(dtype)


@pytest.fixture(autouse=True)
def _default_impls(monkeypatch):
    for env in (tk.PANEL_IMPL_ENV, tk.UPDATE_IMPL_ENV, tcomm.BCAST_IMPL_ENV):
        monkeypatch.delenv(env, raising=False)


# ---------------------------------------------------------------------------
# getri_mesh / potri_mesh
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_inverse(kind, dtype_name):
    dtype = np.dtype(dtype_name).type
    a = _general(dtype) if kind == "getri" else _hpd(dtype)
    fn = jp.getri_mesh if kind == "getri" else jp.potri_mesh
    x, info = fn(jnp.asarray(a), _jmesh(), nb=NB)
    return np.asarray(x), int(info)


JAX_INV = {("getri", "float64"), ("getri", "complex64"), ("potri", "complex128")}


@pytest.mark.parametrize("kind", ["getri", "potri"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mesh_inverse_matches_reference(kind, dtype):
    a = _general(dtype) if kind == "getri" else _hpd(dtype)
    x, info = (getri_mesh if kind == "getri" else potri_mesh)(_t(a), _tmesh(), nb=NB)
    x = x.numpy()
    assert int(info) == 0 and x.shape == (N, N) and x.dtype == a.dtype
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    resid = np.abs(a.astype(wide) @ x.astype(wide) - np.eye(N)).max()
    assert resid / (N * _eps(dtype) * np.abs(a).max() * np.abs(x).max()) < 100
    xref = np.linalg.inv(a.astype(wide))
    assert np.abs(x - xref).max() / np.abs(xref).max() < 100 * _rtol(dtype)
    if (kind, np.dtype(dtype).name) in JAX_INV:
        want, jinfo = _jax_inverse(kind, np.dtype(dtype).name)
        assert jinfo == int(info)
        assert np.abs(x - want).max() / np.abs(want).max() < _rtol(dtype)


def test_getri_mesh_singular_info_matches_jax():
    # an exactly zero column j: U[j, j] = 0, info j + 1 (tests/test_parallel.py)
    a = _general(np.float64, 3)
    a[:, 5] = 0.0
    _, info = getri_mesh(_t(a), _tmesh(), nb=NB)
    _, jinfo = jp.getri_mesh(jnp.asarray(a), _jmesh(), nb=NB)
    assert int(info) == int(jinfo) == 6


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_potri_mesh_non_spd_info_matches_jax(monkeypatch, impl):
    # PanelImpl pinned on both sides (ROADMAP section 3: under auto the
    # port's CPU twin and slate_tpu's CPU xla form report different rows)
    monkeypatch.setenv(tk.PANEL_IMPL_ENV, impl)
    n = 40
    a = _hpd(np.float64, 4)[:n, :n].copy()
    a[23, 23] = -1e3
    _, info = potri_mesh(_t(a), _tmesh(), nb=NB)
    _, jinfo = jp.potrf_mesh(jnp.asarray(a), _jmesh(), nb=NB)
    assert int(info) == int(jinfo) != 0


# ---------------------------------------------------------------------------
# trsm_dist_right
# ---------------------------------------------------------------------------

MR = 36  # rows of B: X op(A) = B with B (36, 60)


def _tri_operands(dtype, uplo_name, seed=5):
    a = _rand((N, N), dtype, seed) + N * np.eye(N)
    t = np.tril(a) if uplo_name == "Lower" else np.triu(a)
    return a.astype(dtype), t.astype(dtype), _rand((MR, N), dtype, seed + 1)


@functools.lru_cache(maxsize=None)
def _jax_trsm_right(dtype_name, uplo_name, op_name, diag_name):
    a, _, b = _tri_operands(np.dtype(dtype_name).type, uplo_name)
    mesh = _jmesh()
    x = jtrsm.trsm_dist_right(jp.from_dense(jnp.asarray(a), mesh, NB, diag_pad_one=True),
                              jp.from_dense(jnp.asarray(b), mesh, NB), jt.Uplo[uplo_name],
                              jt.Op[op_name], jt.Diag[diag_name])
    return np.asarray(jp.to_dense(x))


JAX_TRSM_R = {("float64", "Lower", "NoTrans", "NonUnit"),
              ("complex128", "Upper", "ConjTrans", "NonUnit"),
              ("float32", "Upper", "Trans", "Unit")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("uplo", [tt.Uplo.Lower, tt.Uplo.Upper])
@pytest.mark.parametrize("op", [tt.Op.NoTrans, tt.Op.Trans, tt.Op.ConjTrans])
@pytest.mark.parametrize("diag", [tt.Diag.NonUnit, tt.Diag.Unit])
def test_trsm_dist_right_matches_reference(dtype, uplo, op, diag):
    a, t, b = _tri_operands(dtype, uplo.name)
    mesh = _tmesh()
    x = to_dense(trsm_dist_right(from_dense(_t(a), mesh, NB, diag_pad_one=True),
                                 from_dense(_t(b), mesh, NB), uplo, op, diag)).numpy()
    tw = t.astype(np.complex128 if np.iscomplexobj(t) else np.float64)
    if diag == tt.Diag.Unit:
        np.fill_diagonal(tw, 1)
    opt = {tt.Op.NoTrans: tw, tt.Op.Trans: tw.T, tt.Op.ConjTrans: tw.conj().T}[op]
    resid = np.abs(x @ opt - b).max()
    scale = np.abs(x).max() * np.abs(tw).max() + np.abs(b).max()
    assert resid <= 10 * N * _eps(dtype) * scale
    key = (np.dtype(dtype).name, uplo.name, op.name, diag.name)
    if key in JAX_TRSM_R:
        want = _jax_trsm_right(*key)
        assert np.abs(x - want).max() <= 100 * N * _eps(dtype) * np.abs(want).max()


def test_trsm_dist_right_requires_diag_pad():
    mesh = _tmesh()
    a, _, b = _tri_operands(np.float64, "Lower")
    with pytest.raises(ValueError):
        trsm_dist_right(from_dense(_t(a), mesh, NB), from_dense(_t(b), mesh, NB))


@pytest.mark.parametrize("op", [tt.Op.NoTrans, tt.Op.ConjTrans])
def test_trsm_dist_right_lookahead_and_bcast_impl_bitwise(op):
    mesh = _tmesh()
    a, _, b = _tri_operands(np.complex128, "Lower")
    ad, bd = from_dense(_t(a), mesh, NB, diag_pad_one=True), from_dense(_t(b), mesh, NB)
    outs = {f"la{la}": to_dense(trsm_dist_right(ad, bd, tt.Uplo.Lower, op, lookahead=la))
            for la in (0, 1, 2)}
    outs.update({impl: to_dense(trsm_dist_right(ad, bd, tt.Uplo.Lower, op, bcast_impl=impl))
                 for impl in ("psum", "ring", "doubling")})
    for k, v in outs.items():
        assert torch.equal(v, outs["la1"]), k


@pytest.mark.parametrize("impl", ["psum", "ring"])
def test_trsm_dist_right_audit_bytes_match_jax(impl):
    # a fresh trace of slate_tpu's kernel (nb = 10: no other test compiles it)
    nb, n, m = 10, 44, 26
    a, _, _ = _tri_operands(np.float64, "Upper")
    a = a[:n, :n]
    b = _rand((m, n), np.float64, 9)
    jmesh, tmesh = _jmesh(), _tmesh()
    ja = jp.from_dense(jnp.asarray(a), jmesh, nb, diag_pad_one=True)
    jb = jp.from_dense(jnp.asarray(b), jmesh, nb)
    want = {}
    with jcomm.comm_audit() as rec:
        for op in (jt.Op.NoTrans, jt.Op.Trans):
            jax.make_jaxpr(jtrsm._trsm_right_jit.__wrapped__,
                           static_argnums=(2, 3, 4, 5, 6, 7, 8, 9, 10))(
                ja.tiles, jb.tiles, jmesh, 2, 4, ja.nt, jt.Uplo.Upper, op, jt.Diag.NonUnit, 1,
                impl)
    for op_, nbytes, mult in rec:
        want[op_] = want.get(op_, 0) + nbytes * mult
    ta = from_dense(_t(a), tmesh, nb, diag_pad_one=True)
    tb = from_dense(_t(b), tmesh, nb)
    with tcomm.comm_audit() as trec:
        for op in (tt.Op.NoTrans, tt.Op.Trans):
            trsm_dist_right(ta, tb, tt.Uplo.Upper, op, lookahead=1, bcast_impl=impl)
    got = {}
    for op_, nbytes, mult in trec:
        got[op_] = got.get(op_, 0) + nbytes * mult
    assert want and got == want


# ---------------------------------------------------------------------------
# the band multiplies on the mesh
# ---------------------------------------------------------------------------


def _band(a, kl, ku):
    i, j = np.indices(a.shape)
    return np.where((j - i <= ku) & (i - j <= kl), a, 0).astype(a.dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
def test_gbmm_hbmm_mesh_match_jax(dtype):
    n, kl, ku = 60, 5, 3
    ab = _band(_rand((n, n), dtype, 11), kl, ku)
    b = _rand((n, 8), dtype, 12)
    hb = _band(_rand((n, n), dtype, 13), 4, 4)
    hb = ((hb + hb.conj().T) / 2).astype(dtype)
    tmesh = _tmesh()
    c = gbmm_mesh(1.0, _t(ab), kl, ku, _t(b), tmesh, nb=NB).numpy()
    c2 = hbmm_mesh(tt.Side.Left, 1.0, _t(hb), 4, _t(b), tmesh, nb=NB).numpy()
    c3 = hbmm_mesh(tt.Side.Right, 1.0, _t(hb), 4, _t(b.T.copy()), tmesh, nb=NB,
                   uplo=tt.Uplo.Upper).numpy()
    tol = 10 * n * _eps(dtype) * np.abs(b).max() * max(np.abs(ab).max(), np.abs(hb).max())
    assert np.abs(c - ab @ b).max() <= tol
    assert np.abs(c2 - hb @ b).max() <= tol
    assert np.abs(c3 - b.T @ hb).max() <= tol
    if dtype == np.complex128:
        jmesh = _jmesh()
        jc = np.asarray(jp.gbmm_mesh(1.0, jnp.asarray(ab), kl, ku, jnp.asarray(b), jmesh, nb=NB))
        jc2 = np.asarray(jp.hbmm_mesh(jt.Side.Left, 1.0, jnp.asarray(hb), 4, jnp.asarray(b),
                                      jmesh, nb=NB))
        assert np.abs(c - jc).max() <= tol and np.abs(c2 - jc2).max() <= tol


# ---------------------------------------------------------------------------
# the dryrun's hemm_summa phase
# ---------------------------------------------------------------------------


def test_dryrun_runs_four_phases_on_the_cpu():
    res = tdry.dryrun("cpu")
    assert res["ok"], res
    assert list(res["phases"]) == ["posv_chain", "gesv_pp", "hemm_summa", "stedc_dist",
                                   "heev_chain", "panel_pallas", "flight_timeline", "mem"]
    assert res["phases"]["hemm_summa"]["resid"] < 1e-4


def test_dryrun_hemm_phase_matches_jax():
    ops = tdry.dryrun_operands()
    hm, b = ops["hm"], ops["b"]
    # the operands __graft_entry__.py draws: H = (G + G^T) / 2 from the
    # posv_chain phase's G, in f32
    rng = np.random.default_rng(0)
    g = rng.standard_normal((tdry.N, tdry.N)).astype(np.float32)
    np.testing.assert_array_equal(hm, ((g + g.T) / 2).astype(np.float32))
    tmesh, jmesh = _tmesh(), _jmesh()
    got = to_dense(tdry.hemm_summa(tt.Side.Left, 1.0, from_dense(_t(hm), tmesh, tdry.NB),
                                   from_dense(_t(b), tmesh, tdry.NB))).numpy()
    want = np.asarray(jp.to_dense(jb3.hemm_summa(jt.Side.Left, 1.0,
                                                 jp.from_dense(jnp.asarray(hm), jmesh, tdry.NB),
                                                 jp.from_dense(jnp.asarray(b), jmesh, tdry.NB))))
    tol = 10 * tdry.N * _eps(np.float32) * np.abs(hm).max() * np.abs(b).max()
    assert np.abs(got - want).max() <= tol
    resid = tdry.hemm_residual(_t(hm), _t(b), tmesh)
    assert resid < 1e-4
