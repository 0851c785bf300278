"""The port's distributed CAQR and least squares (slate_tpu_torch.parallel:
geqrf_dist, unmqr_dist, geqrf_mesh, gels_mesh) against slate_tpu.parallel.

The same seeded numpy operands go through ``slate_tpu``'s mesh drivers on
the 8 forced CPU devices of conftest.py (a 2 x 4 mesh; PanelImpl ``pallas``,
so ``qr_panel_offset_pallas`` runs interpreted) and through the port's on a
virtual 2 x 4 mesh on the CPU, where the kernel wrappers take their plain
twins.  nb = 8; the dryrun's n = 64 and a ragged m = 100, n = 40 (13 tile
rows padded to 16, 5 tile columns to 8).

Bitwise: info codes, audited comm bytes per op (for two broadcast
lowerings, each on its own tile grid: ``slate_tpu`` records at trace time),
and the port's own results across lowerings and PanelImpl.  Factors (the
packed V\\R, T_loc, the tree factors) hold to 100 m eps of the reference at
their own scale; ``unmqr_dist`` on identical factors (carried across by
``distqr_from_numpy``) to 100 m eps max|B|; the solutions to each other
within 100 m eps max|X| and to the normal-equations gate < 100 n eps, and
for m > n to the componentwise one (``gels_omega``, f64) < 20 eps / sqrt(m).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import types as jt
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import drivers as jdrv
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu.parallel.dist_qr import unmqr_dist as junmqr_dist
from slate_tpu.utils.testing import generate
from slate_tpu_torch import parallel as tp
from slate_tpu_torch import types as tt
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dist_qr as tdq
from slate_tpu_torch.utils.testing import distqr_from_numpy, gels_omega, gels_omega_gate

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

NB = 8
DTYPES = [np.float32, np.float64]
SIZES = [(64, 64), (100, 40)]
_J_OPTS = {jt.Option.PanelImpl: "pallas", jt.Option.NumMonitor: "off"}


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _jmesh():
    return jmake_mesh(2, 4, devices=cpu_devices(8))


def _tmesh():
    return tp.make_mesh(2, 4, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(m, n, dtype, nrhs=5, seed=0):
    return (generate("randn", m, n, dtype=dtype, seed=seed + m + n),
            generate("randn", m, nrhs, dtype=dtype, seed=seed + m + n + 1))


def _close(got, ref, c, m, dtype, scale=None):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    err = float(np.abs(got - ref).max())
    assert err <= c * m * _eps(dtype) * max(scale, 1e-30), (err, c * m * _eps(dtype) * scale)


def _totals(records):
    out = {}
    for op, nbytes, mult in records:
        out[op] = out.get(op, 0) + nbytes * mult
    return out


@pytest.fixture(autouse=True)
def _default_impls(monkeypatch):
    for env in (tk.PANEL_IMPL_ENV, tcomm.BCAST_IMPL_ENV, "SLATE_TPU_CKPT"):
        monkeypatch.delenv(env, raising=False)


# ---------------------------------------------------------------------------
# audited bytes first: slate_tpu records at trace time, so each lowering
# gets a tile grid of its own that no other test of this module compiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,m,n", [("psum", 72, 48), ("ring", 80, 56), ("doubling", 88, 40)])
def test_audited_bytes_match_per_op(impl, m, n):
    a, b = _operands(m, n, np.float32, seed=90)
    jm, tm = _jmesh(), _tmesh()
    jopts = {**_J_OPTS, jt.Option.BcastImpl: impl}
    with jcomm.comm_audit() as jrec:
        jf = jdrv.geqrf_mesh(jnp.asarray(a), jm, NB, opts=jopts)
    with tcomm.comm_audit() as trec:
        tf = tp.geqrf_mesh(a, tm, NB, opts={tt.Option.BcastImpl: impl})
    assert _totals(trec) == _totals(jrec) and _totals(trec)
    with jcomm.comm_audit() as jrec:
        junmqr_dist(jf, jfrom_dense(jnp.asarray(b), jm, NB), jt.Op.ConjTrans, bcast_impl=impl)
    with tcomm.comm_audit() as trec:
        tp.unmqr_dist(tf, tp.from_dense(_t(b), tm, NB), tt.Op.ConjTrans, bcast_impl=impl)
    assert _totals(trec) == _totals(jrec) and _totals(trec)
    hop = "psum[q]" if impl == "psum" else "ppermute[q]"
    assert hop in _totals(trec)


# ---------------------------------------------------------------------------
# JAX references, computed once per configuration
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_qr(m, n, dtype_name):
    dtype = np.dtype(dtype_name).type
    a, b = _operands(m, n, dtype)
    mesh = _jmesh()
    f = jdrv.geqrf_mesh(jnp.asarray(a), mesh, NB, opts=_J_OPTS)
    x, info = jdrv.gels_mesh(jnp.asarray(a), jnp.asarray(b), mesh, NB, opts=_J_OPTS)
    qb = {op: np.asarray(jto_dense(junmqr_dist(f, jfrom_dense(jnp.asarray(b), mesh, NB), getattr(jt.Op, op))))
          for op in ("ConjTrans", "NoTrans")}
    return {"fact": np.asarray(jto_dense(f.fact)), "tiles": np.asarray(f.fact.tiles),
            "tloc": np.asarray(f.tloc), "treev": np.asarray(f.treev), "treet": np.asarray(f.treet),
            "x": np.asarray(x), "info": int(info), "qb": qb}


@functools.lru_cache(maxsize=None)
def _port_qr(m, n, dtype_name):
    dtype = np.dtype(dtype_name).type
    a, b = _operands(m, n, dtype)
    mesh = _tmesh()
    f = tp.geqrf_mesh(a, mesh, NB)
    x, info = tp.gels_mesh(a, b, mesh, NB)
    return f, x, int(info)


@pytest.mark.parametrize("m,n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_geqrf_dist_factors_match(m, n, dtype):
    ref = _jax_qr(m, n, np.dtype(dtype).name)
    f, _, _ = _port_qr(m, n, np.dtype(dtype).name)
    a, _ = _operands(m, n, dtype)
    scale = float(np.abs(a).max()) * np.sqrt(m)
    _close(tp.to_dense(f.fact).numpy(), ref["fact"], 100, m, dtype, scale)
    for name in ("tloc", "treev", "treet"):
        _close(getattr(f, name).numpy(), ref[name], 100, m, dtype)
    assert tuple(f.tloc.shape) == ref["tloc"].shape and tuple(f.treev.shape) == ref["treev"].shape
    # R = Q^H A: R's diagonal magnitudes are the column norms the factor
    # must reproduce (|R| of a QR is unique)
    r = np.triu(tp.to_dense(f.fact).numpy()[:n, :n]).astype(np.float64)
    _close(np.abs(np.diag(r)), np.abs(np.linalg.qr(a.astype(np.float64))[1].diagonal()), 100, m, dtype)


@pytest.mark.parametrize("op", ["ConjTrans", "NoTrans"])
@pytest.mark.parametrize("m,n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_unmqr_dist_on_identical_factors(op, m, n, dtype):
    ref = _jax_qr(m, n, np.dtype(dtype).name)
    _, b = _operands(m, n, dtype)
    mesh = _tmesh()
    f = distqr_from_numpy(ref["tiles"], ref["tloc"], ref["treev"], ref["treet"], m, n, NB, mesh)
    got = tp.to_dense(tp.unmqr_dist(f, tp.from_dense(_t(b), mesh, NB), getattr(tt.Op, op))).numpy()
    _close(got, ref["qb"][op], 100, m, dtype, float(np.abs(b).max()))
    # Q Q^H B = B through the port alone
    back = tp.unmqr_dist(f, tp.unmqr_dist(f, tp.from_dense(_t(b), mesh, NB), tt.Op.ConjTrans),
                         tt.Op.NoTrans)
    _close(tp.to_dense(back).numpy(), b, 100, m, dtype)


@pytest.mark.parametrize("m,n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gels_mesh_matches(m, n, dtype):
    ref = _jax_qr(m, n, np.dtype(dtype).name)
    _, x, info = _port_qr(m, n, np.dtype(dtype).name)
    a, b = _operands(m, n, dtype)
    assert info == ref["info"] == 0
    x = x.numpy()
    assert x.shape == (n, b.shape[1]) and np.isfinite(x).all()
    _close(x, ref["x"], 100, m, dtype)
    a64, x64 = a.astype(np.float64), x.astype(np.float64)
    gate = np.abs(a64.T @ (a64 @ x64 - b)).max() / (np.abs(a64).max() ** 2 * np.abs(x64).max() * m)
    assert gate < 100 * n * _eps(dtype)
    if m > n:  # the componentwise gate, on both packages' X
        for xs in (x, ref["x"]):
            assert gels_omega(_t(a), _t(xs), _t(b)) < gels_omega_gate(m, torch.float32 if dtype == np.float32
                                                                     else torch.float64)


@pytest.mark.parametrize("j", [0, 13, 39])
def test_gels_mesh_zero_column_info(j):
    m, n = 100, 40
    a, b = _operands(m, n, np.float64, seed=5)
    a[:, j] = 0
    _, jinfo = jdrv.gels_mesh(jnp.asarray(a), jnp.asarray(b), _jmesh(), NB, opts=_J_OPTS)
    x, info = tp.gels_mesh(a, b, _tmesh(), NB)
    assert int(info) == int(jinfo) == j + 1
    assert info.dtype == torch.int32


def test_port_bitwise_across_lowerings_and_panel_impls():
    m, n = 64, 64
    a, b = _operands(m, n, np.float64, seed=3)
    mesh = _tmesh()
    runs = {}
    for impl in ("psum", "ring", "doubling"):
        runs[impl] = tp.gels_mesh(a, b, mesh, NB, opts={tt.Option.BcastImpl: impl})[0]
    for pimpl in ("xla", "pallas"):
        runs[pimpl] = tp.gels_mesh(a, b, mesh, NB, opts={tt.Option.PanelImpl: pimpl})[0]
    for k, v in runs.items():
        assert torch.equal(v, runs["psum"]), k


def test_options_and_refusals(monkeypatch):
    a, b = _operands(64, 40, np.float32)
    mesh = _tmesh()
    # Option.Checkpoint is ported (ft.ckpt.geqrf_ckpt): the plain bits
    f0 = tp.geqrf_mesh(a, mesh, NB)
    f1 = tp.geqrf_mesh(a, mesh, NB, opts={tt.Option.Checkpoint: 3})
    assert torch.equal(f0.fact.tiles, f1.fact.tiles)
    assert all(torch.equal(x, y) for x, y in zip(f0[1:], f1[1:]))
    x0 = tp.gels_mesh(a, b, mesh, NB)
    monkeypatch.setenv("SLATE_TPU_CKPT", "2")
    x1 = tp.gels_mesh(a, b, mesh, NB)
    assert torch.equal(x0[0], x1[0]) and torch.equal(x0[1], x1[1])
    monkeypatch.delenv("SLATE_TPU_CKPT")
    # Option.NumMonitor is ported: "on" gives the plain bits
    f_on, f_off = (tp.geqrf_mesh(a, mesh, NB, opts={tt.Option.NumMonitor: m}) for m in ("on", "off"))
    assert torch.equal(f_on.fact.tiles, f_off.fact.tiles) and torch.equal(f_on.tloc, f_off.tloc)
    with pytest.raises(ValueError, match="m >= n"):
        tp.geqrf_dist(tp.from_dense(_t(a.T.copy()), mesh, NB))
    f = tp.geqrf_mesh(a, mesh, NB)
    with pytest.raises(ValueError, match="mismatch"):
        tp.unmqr_dist(f, tp.from_dense(_t(b[:32]), mesh, NB))
    with pytest.raises(ValueError, match="shapes"):
        distqr_from_numpy(f.fact.tiles.numpy(), f.tloc.numpy()[:1], f.treev.numpy(), f.treet.numpy(),
                          64, 40, NB, mesh)
    # overwrite_a writes the factor into the operand's own stack
    ad = tp.from_dense(_t(a), mesh, NB)
    assert tp.geqrf_dist(ad, overwrite_a=True).fact.tiles.data_ptr() == ad.tiles.data_ptr()
    assert tp.geqrf_dist(tp.from_dense(_t(a), mesh, NB)).fact.tiles.data_ptr() != ad.tiles.data_ptr()


def test_tree_schedule_matches():
    from slate_tpu.parallel import dist_qr as jdq

    for p in (1, 2, 3, 4, 5, 8):
        assert tdq._tree_rounds(p) == jdq._tree_rounds(p)
        assert tdq._merge_ids(p) == jdq._merge_ids(p)
        for k in range(6):
            assert tdq._rot(k, p) == [int(x) for x in np.asarray(jdq._rot(k, p))]
            for r in range(p):
                row0, has = jdq._local_panel_geometry(k, r, p, 3, NB)
                assert tdq._local_panel_geometry(k, r, p, 3, NB) == (int(row0), bool(has))


def test_mesh_wrappers_count_nothing_on_cpu():
    before = (tk.qr_panel.launches, tk.qr_panel_offset.launches)
    _port_qr(64, 64, "float32")
    tp.geqrf_mesh(*_operands(64, 64, np.float32)[:1], _tmesh(), NB)
    assert (tk.qr_panel.launches, tk.qr_panel_offset.launches) == before
