"""The port's non-uniform tiling (from_dense_nonuniform / to_dense_nonuniform
/ redistribute_nonuniform) against slate_tpu, mirroring
tests/test_parallel.py:940-1000 (the reference's ex13).

``slate_tpu`` on the 8 forced CPU devices of conftest.py (a 2 x 4 mesh);
the port on a virtual 2 x 4 mesh on the CPU; the same seeded numpy
operands.  Bitwise: the embedded tile stack, the round trip, info codes and
pivots, and the ValueError of a size mismatch.  Stated tolerances: the
non-uniform gemm_summa within 100 k eps max|A| max|B| of slate_tpu's and
of the numpy product (two summation orders over k = 96 terms); the factors
of potrf_dist and getrf_pp_dist within 100 n eps max|A| of slate_tpu's
(tests/test_torch_mesh.py's class), with ``panel_impl`` pinned to
``pallas`` on both sides (ROADMAP §3: their CPU ``auto`` differ).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import parallel as jp
from slate_tpu.parallel.dist_chol import potrf_dist as jpotrf_dist
from slate_tpu.parallel.dist_lu import getrf_pp_dist as jgetrf_pp_dist
from slate_tpu.types import Diag as JDiag
from slate_tpu.types import Op as JOp
from slate_tpu.types import Uplo as JUplo
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.types import Diag, Op, Uplo

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


ROWSZ = [16, 8, 24, 16, 8, 24]
COLSZ = [8, 24, 16, 8, 24, 16]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jmesh():
    return jp.make_mesh(2, 4, devices=cpu_devices(8))


def _tmesh():
    return tp.make_mesh(2, 4, device="cpu")


def _rand(shape, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _spd(n, seed):
    g = _rand((n, n), seed)
    return g @ g.T + n * np.eye(n)


def _eps(dtype):
    return float(np.finfo(np.dtype(dtype)).eps)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
@pytest.mark.parametrize("sizes", [(ROWSZ, COLSZ), ([5, 31, 17, 1, 30, 12], [96]),
                                   ([7] * 13 + [5], [50, 46])])
def test_nonuniform_roundtrip_and_tiles_bitwise(dtype, sizes):
    rows, cols = sizes
    a = _rand((sum(rows), sum(cols)), 1, dtype)
    td = tp.from_dense_nonuniform(_t(a), _tmesh(), rows, cols)
    jd = jp.from_dense_nonuniform(jnp.asarray(a), _jmesh(), rows, cols)
    assert (td.m, td.n, td.nb, td.diag_pad) == (jd.m, jd.n, jd.nb, jd.diag_pad)
    assert td.nb == max(rows + cols)
    np.testing.assert_array_equal(td.tiles.numpy(), np.asarray(jd.tiles))
    np.testing.assert_array_equal(tp.to_dense_nonuniform(td, rows, cols).numpy(), a)


def test_nonuniform_to_dense_matches_jax():
    """slate_tpu's per-tile read-back (one ``.at[].set`` a tile, seconds on
    the CPU: once here) gives the port's one-gather read-back bitwise."""
    a = _rand((96, 96), 9)
    jd = jp.from_dense_nonuniform(jnp.asarray(a), _jmesh(), ROWSZ, COLSZ)
    td = tp.from_dense_nonuniform(_t(a), _tmesh(), ROWSZ, COLSZ)
    np.testing.assert_array_equal(tp.to_dense_nonuniform(td, ROWSZ, COLSZ).numpy(),
                                  np.asarray(jp.to_dense_nonuniform(jd, ROWSZ, COLSZ)))


def test_nonuniform_gemm_matches_jax():
    a, b = _rand((96, 96), 2), _rand((96, 96), 3)
    ad = tp.from_dense_nonuniform(_t(a), _tmesh(), ROWSZ, COLSZ)
    bd = tp.from_dense_nonuniform(_t(b), _tmesh(), COLSZ, ROWSZ)
    c = tp.to_dense_nonuniform(tp.gemm_summa(1.0, ad, bd), ROWSZ, ROWSZ).numpy()
    jad = jp.from_dense_nonuniform(jnp.asarray(a), _jmesh(), ROWSZ, COLSZ)
    jbd = jp.from_dense_nonuniform(jnp.asarray(b), _jmesh(), COLSZ, ROWSZ)
    cj = np.asarray(jp.to_dense_nonuniform(jp.gemm_summa(1.0, jad, jbd), ROWSZ, ROWSZ))
    tol = 100 * 96 * _eps(np.float64) * np.abs(a).max() * np.abs(b).max()
    assert np.abs(c - cj).max() < tol
    assert np.abs(c - a @ b).max() < tol


def test_nonuniform_size_mismatch_raises():
    a = _rand((64, 64), 4)
    with pytest.raises(ValueError):
        jp.from_dense_nonuniform(jnp.asarray(a), jp.make_mesh(2, 2, devices=cpu_devices(4)),
                                 [32, 16], [32, 32])
    with pytest.raises(ValueError, match="tile the matrix exactly"):
        tp.from_dense_nonuniform(_t(a), tp.make_mesh(2, 2, device="cpu"), [32, 16], [32, 32])
    with pytest.raises(ValueError, match="tile the matrix exactly"):
        tp.from_dense_nonuniform(_t(a), _tmesh(), [64], [32, 16, 8])


@pytest.mark.parametrize("nb", [16, 8])
def test_nonuniform_potrf_dist_matches_jax(nb):
    n = 96
    a = _spd(n, 5)
    ad = tp.redistribute_nonuniform(tp.from_dense_nonuniform(_t(a), _tmesh(), ROWSZ, ROWSZ),
                                    ROWSZ, ROWSZ, nb=nb, diag_pad_one=True)
    jad = jp.redistribute_nonuniform(jp.from_dense_nonuniform(jnp.asarray(a), _jmesh(), ROWSZ, ROWSZ),
                                     ROWSZ, ROWSZ, nb=nb, diag_pad_one=True)
    assert (ad.nb, ad.diag_pad) == (jad.nb, jad.diag_pad) == (nb, True)
    np.testing.assert_array_equal(ad.tiles.numpy(), np.asarray(jad.tiles))
    l, info = tp.potrf_dist(ad, panel_impl="pallas")
    lj, infoj = jpotrf_dist(jad, panel_impl="pallas", update_impl="pallas", num_monitor="off")
    assert int(info) == int(infoj) == 0
    ld, ldj = np.tril(tp.to_dense(l).numpy()), np.tril(np.asarray(jp.to_dense(lj)))
    assert np.abs(ld - ldj).max() < 100 * n * _eps(np.float64) * np.abs(a).max()
    assert np.abs(ld @ ld.T - a).max() / np.abs(a).max() < 1e-12
    # the two trsm_dist of the solve, as the reference's posv would run them
    b = _rand((n, 4), 6)
    bd = tp.from_dense(_t(b), _tmesh(), nb)
    y = tp.trsm_dist(l, bd, Uplo.Lower, Op.NoTrans, Diag.NonUnit)
    x = tp.to_dense(tp.trsm_dist(l, y, Uplo.Lower, Op.ConjTrans, Diag.NonUnit)).numpy()
    assert np.abs(a @ x - b).max() / (np.abs(a).max() * np.abs(x).max() * n) < 100 * n * _eps(np.float64)


def test_nonuniform_getrf_pp_dist_matches_jax():
    n = 96
    g = _rand((n, n), 7)
    gd = tp.redistribute_nonuniform(tp.from_dense_nonuniform(_t(g), _tmesh(), ROWSZ, ROWSZ),
                                    ROWSZ, ROWSZ, nb=16, diag_pad_one=True)
    jgd = jp.redistribute_nonuniform(jp.from_dense_nonuniform(jnp.asarray(g), _jmesh(), ROWSZ, ROWSZ),
                                     ROWSZ, ROWSZ, nb=16, diag_pad_one=True)
    lu, perm, info = tp.getrf_pp_dist(gd, panel_impl="pallas")
    luj, permj, infoj = jgetrf_pp_dist(jgd, panel_impl="pallas", num_monitor="off")
    assert int(info) == int(infoj) == 0
    np.testing.assert_array_equal(perm.numpy(), np.asarray(permj))
    tol = 100 * n * _eps(np.float64) * np.abs(g).max()
    assert np.abs(tp.to_dense(lu).numpy() - np.asarray(jp.to_dense(luj))).max() < tol
    b = _rand((n, 4), 8)
    bd = tp.permute_rows_dist(tp.from_dense(_t(b), _tmesh(), 16), perm)
    y = tp.trsm_dist(lu, bd, Uplo.Lower, Op.NoTrans, Diag.Unit)
    x = tp.to_dense(tp.trsm_dist(lu, y, Uplo.Upper, Op.NoTrans)).numpy()
    jbd = jp.permute_rows_dist(jp.from_dense(jnp.asarray(b), _jmesh(), 16), permj)
    jy = jp.trsm_dist(luj, jbd, JUplo.Lower, JOp.NoTrans, JDiag.Unit)
    xj = np.asarray(jp.to_dense(jp.trsm_dist(luj, jy, JUplo.Upper, JOp.NoTrans)))
    assert np.abs(g @ x - b).max() / np.abs(b).max() < 1e-10
    assert np.abs(x - xj).max() < 100 * n * _eps(np.float64) * np.linalg.cond(g) * np.abs(xj).max()
