"""The port's Ozaki split-integer f64 GEMM (slate_tpu_torch.ops.ozaki) and
its pieces against slate_tpu.ops.ozaki.

Every function is BITWISE ``slate_tpu``'s on the CPU: the digit planes and
row exponents (``split_rows``, ``split_tiles``, ``row_exp_from_absmax``),
the anti-diagonal products (``plane_diag_term``), the f32 pair cascade of
``matmul_planes`` / ``matmul_f64``, the f64 fold of
``accumulate_diag_planes`` and the Karatsuba ``matmul_c128``.
product across the (2, 4), (1, 8) and (2, 2) grids, with and without a
presplit A carried over from ``slate_tpu``.  The inputs cover rows of
zeros, rows near the f32 exponent limits the module allows (max 1e37,
2e-37), elements that are f32 subnormals (``slate_tpu``'s platforms flush
them; the port flushes them explicitly), scales 1e8 and 1e-12, and a k
just above ``_K_CHUNK`` (16 x 8200 @ 8200 x 16), at S = 9 and 6.  The mesh
product is in ``test_torch_ozaki_mesh.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import ozaki as jo
from slate_tpu_torch.ops import ozaki as to

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

SHAPES = [(64, 64, 64), (37, 300, 65), (16, 8200, 16)]

# slate_tpu runs these inside its jitted matmul_f64 / SUMMA kernels; jitting
# them here compiles each once (every step is exact, so fusion changes no bit)
_jsplit_rows = jax.jit(jo.split_rows, static_argnums=1)
_jsplit_tiles = jax.jit(jo.split_tiles, static_argnums=2)
_jplanes = jax.jit(jo.matmul_planes)
_jdiag = jax.jit(jo.plane_diag_term, static_argnums=2)
_jacc = jax.jit(jo.accumulate_diag_planes, static_argnums=3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(j, t):
    """Bitwise equality (NaN and signed zero included)."""
    j, t = np.asarray(j), t.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype
    np.testing.assert_array_equal(j.view(np.uint8), t.view(np.uint8))


def _hard_rows(a):
    """Rows of zeros, rows near the f32 exponent limits, f32 subnormals."""
    a = a.copy()
    a[3] = 0
    a[5] *= 1e37 / np.abs(a[5]).max()
    a[6] *= 2e-37 / np.abs(a[6]).max()
    a[7, :5] = [1e-40, -3e-39, 5e-42, 1e-45, -1e-44]
    a[8] *= 1e-30  # lo components below the f32 normal range
    return a


@pytest.mark.parametrize("shape", SHAPES)
def test_matmul_f64_is_bitwise_the_reference(shape):
    m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    a = _hard_rows(rng.standard_normal((m, k)))
    b = rng.standard_normal((k, n))
    for s in (9, 6):
        _same(jo.matmul_f64(jnp.asarray(a), jnp.asarray(b), n_slices=s),
              to.matmul_f64(_t(a), _t(b), n_slices=s))
    plain = rng.standard_normal((m, k))  # rescaled whole (the hard rows would leave f32's range)
    for scale in (1e8, 1e-12):
        _same(jo.matmul_f64(jnp.asarray(plain * scale), jnp.asarray(b)),
              to.matmul_f64(_t(plain * scale), _t(b)))
    # f64-grade per row, the 1e37 row and the zero row included.  Rows 6 and 8
    # (max 2e-37, 1e-30) lose the lo components that fall below f32's normal
    # range to the flush, in both packages alike (bitwise above)
    ref = a @ b
    c = to.matmul_f64(_t(a), _t(b)).numpy()
    rows = np.r_[0:6, 7, 9:m]
    assert (np.abs(c - ref)[rows].max(axis=1) <= 1e-13 * np.abs(ref)[rows].max(axis=1)).all()


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_splits_and_planes_are_bitwise_the_reference(shape):
    m, k, n = shape
    rng = np.random.default_rng(7 + m)
    a = _hard_rows(rng.standard_normal((m, k)))
    b = rng.standard_normal((k, n))
    qj, ej = _jsplit_rows(jnp.asarray(a), 9)
    qt, et = to.split_rows(_t(a))
    _same(qj, qt)
    _same(ej, et)
    assert qt.dtype == torch.int8 and int(qt.abs().max()) <= 64
    qbj, ebj = _jsplit_rows(jnp.asarray(b.T), 6)
    qbt, ebt = to.split_rows(_t(b.T), 6)
    _same(qbj, qbt)
    # a given row bound
    e = np.full((m, 1), 3.0, np.float32)
    _same(jo.split_rows(jnp.asarray(a[:, :40] / 1e40 + 1), e=jnp.asarray(e))[0],
          to.split_rows(_t(a[:, :40] / 1e40 + 1), e=_t(e))[0])
    _same(_jplanes(qj[:6], ej, qbj, ebj), to.matmul_planes(qt[:6], et, qbt, ebt))
    amax = np.abs(a).max(axis=1).astype(np.float32)
    _same(jo.row_exp_from_absmax(jnp.asarray(amax)), to.row_exp_from_absmax(_t(amax)))
    _same(jo.exp2_scale_f64(ej), to.exp2_scale_f64(et))


def test_tile_stack_forms_are_bitwise_the_reference():
    rng = np.random.default_rng(11)
    x = _hard_rows(rng.standard_normal((3 * 8, 2 * 8))).reshape(3, 8, 2, 8).transpose(0, 2, 1, 3)
    x = np.ascontiguousarray(x)  # (3, 2, 8, 8) tiles
    e = np.asarray(jo.row_exp_from_absmax(jnp.asarray(np.abs(x).max(axis=(1, 3)).astype(np.float32))))
    for s in (9, 6):
        qj = _jsplit_tiles(jnp.asarray(x), jnp.asarray(e[:, None, :, None]), s)
        qt = to.split_tiles(_t(x), _t(e[:, None, :, None]), s)
        _same(qj, qt)
    qa = rng.integers(-64, 65, (9, 3, 8, 8)).astype(np.int8)
    qb = rng.integers(-64, 65, (9, 2, 8, 8)).astype(np.int8)
    for s in range(9):
        _same(_jdiag(jnp.asarray(qa), jnp.asarray(qb), s),
              to.plane_diag_term(_t(qa), _t(qb), s))
    acc = rng.standard_normal((3, 2, 8, 8))
    got = to.accumulate_diag_planes(_t(acc.copy()), _t(qa), _t(qb), 9)
    _same(_jacc(jnp.asarray(acc), jnp.asarray(qa), jnp.asarray(qb), 9), got)
    sa = np.exp2(rng.integers(-5, 5, (3, 1, 8, 1))).astype(np.float64)
    sb = np.exp2(rng.integers(-5, 5, (1, 2, 1, 8))).astype(np.float64)
    _same(jo.scale_rows_cols_f64(jnp.asarray(acc), jnp.asarray(sa), jnp.asarray(sb)),
          to.scale_rows_cols_f64(_t(acc), _t(sa), _t(sb)))


def test_matmul_c128_is_bitwise_the_reference():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 50)) + 1j * rng.standard_normal((40, 50))
    b = rng.standard_normal((50, 30)) - 1j * rng.standard_normal((50, 30))
    for s in (9, 6):
        _same(jo.matmul_c128(jnp.asarray(a), jnp.asarray(b), n_slices=s),
              to.matmul_c128(_t(a), _t(b), n_slices=s))
    ref = a @ b
    c = to.matmul_c128(_t(a), _t(b)).numpy()
    assert np.abs(c - ref).max() / np.abs(ref).max() < 1e-13


def test_operand_types_are_refused():
    z32 = torch.zeros((4, 4), dtype=torch.float32)
    with pytest.raises(TypeError, match="f64"):
        to.matmul_f64(z32, z32)
    with pytest.raises(TypeError, match="c128"):
        to.matmul_c128(z32.double(), z32.double())
