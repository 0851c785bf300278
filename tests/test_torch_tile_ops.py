"""The port's tile operations (slate_tpu_torch.ops.tile_ops) and its three
tile kernels' plain twins against slate_tpu.

The same seeded numpy operands go through ``slate_tpu.ops.tile_ops`` and the
port's ``ops.tile_ops`` on the CPU, in f32, f64, c64 and c128 where
``slate_tpu`` admits them.  Bitwise: transpose, gecopy, geset, tzset,
tzcopy, col_norms and genorm(Max) (moves, selects and maxima round
nothing).  Elementwise within eps (|alpha a| + |beta b|): geadd, tzadd,
gescale, tzscale, gescale_row_col (one or two roundings per entry, in an
order each framework picks).  A complex |a| is a rounded hypot whose
formula differs between the frameworks, so complex col_norms and
genorm(Max) hold to eps relative.  The One / Inf / Fro norms within n eps
relative (sums of n terms in another order).

The twins of ``ops.kernels`` (``transpose_tiles_plain``,
``geadd_tiles_plain``, ``genorm_max_tiles_plain``), which the wrappers run
on a CPU tensor, are held against ``slate_tpu``'s Pallas kernels
themselves, run on the CPU under
``jax.experimental.pallas.tpu.force_tpu_interpret_mode()``, in f32 and bf16
on an mb != nb stack with one NaN tile: transpose and genorm_max bitwise,
NaN included; geadd within eps (|alpha a| + |beta b|), alpha and beta
rounded to the stack's dtype (the twin rounds alpha a + beta b once from
exact products, the interpreted kernel forms fma(alpha, a, beta b)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slate_tpu.ops import pallas_ops as po
from slate_tpu.ops import tile_ops as jto
from slate_tpu.types import Diag as JDiag
from slate_tpu.types import Norm as JNorm
from slate_tpu.types import NormScope as JScope
from slate_tpu.types import Uplo as JUplo
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.ops import tile_ops as tto
from slate_tpu_torch.types import Diag, Norm, NormScope, Uplo

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
_T = {np.float32: torch.float32, np.float64: torch.float64,
      np.complex64: torch.complex64, np.complex128: torch.complex128}


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jaxenum(e, cls):
    return cls[e.name]


def _bitwise(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert _np(got).dtype == np.asarray(want).dtype


def _within(got, want, scale, dtype):
    """|got - want| <= eps * scale elementwise."""
    assert np.all(np.abs(_np(got) - np.asarray(want)) <= _eps(dtype) * scale)


# ---------------------------------------------------------------------------
# elementwise operations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_moves_and_selects_are_bitwise(dtype):
    a, b = _rand((12, 9), dtype, 1), _rand((12, 9), dtype, 2)
    stack = _rand((3, 5, 7), dtype, 3)
    ta, tb, ts = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(stack)
    for conj in (False, True):
        _bitwise(tto.transpose(ts, conj=conj), jto.transpose(jnp.asarray(stack), conj=conj))
    _bitwise(tto.gecopy(ta), jto.gecopy(jnp.asarray(a)))
    lo = np.complex64 if np.issubdtype(dtype, np.complexfloating) else np.float32
    _bitwise(tto.gecopy(ta, _T[lo]), jto.gecopy(jnp.asarray(a), lo))
    _bitwise(tto.geset(0.5, -2.0, (6, 9), _T[dtype], device="cpu"),
             jto.geset(0.5, -2.0, (6, 9), dtype))
    for uplo in (Uplo.Lower, Uplo.Upper):
        ju = _jaxenum(uplo, JUplo)
        _bitwise(tto.tzset(uplo, 3.0, 7.0, ta), jto.tzset(ju, 3.0, 7.0, jnp.asarray(a)))
        _bitwise(tto.tzcopy(uplo, ta, tb), jto.tzcopy(ju, jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_scaled_sums_within_one_rounding(dtype):
    a, b = _rand((12, 9), dtype, 4), _rand((12, 9), dtype, 5)
    r, c = np.abs(_rand((12,), np.float64, 6)), np.abs(_rand((9,), np.float64, 7))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    alpha, beta = 0.75, -1.25
    scale = np.abs(alpha * a) + np.abs(beta * b)
    _within(tto.geadd(alpha, ta, beta, tb), jto.geadd(alpha, jnp.asarray(a), beta, jnp.asarray(b)),
            scale, dtype)
    for uplo in (Uplo.Lower, Uplo.Upper):
        ju = _jaxenum(uplo, JUplo)
        _within(tto.tzadd(uplo, alpha, ta, beta, tb),
                jto.tzadd(ju, alpha, jnp.asarray(a), beta, jnp.asarray(b)), scale, dtype)
        _within(tto.tzscale(uplo, 3.0, 7.0, ta), jto.tzscale(ju, 3.0, 7.0, jnp.asarray(a)),
                2 * np.abs(a), dtype)
    # the ratio and the product each round once: 2 eps |a| (numer / denom)
    _within(tto.gescale(3.0, 7.0, ta), jto.gescale(3.0, 7.0, jnp.asarray(a)),
            2 * np.abs(a) * 3 / 7, dtype)
    _within(tto.gescale_row_col(torch.from_numpy(r), torch.from_numpy(c), ta),
            jto.gescale_row_col(jnp.asarray(r), jnp.asarray(c), jnp.asarray(a)),
            2 * np.abs(a * r[:, None] * c[None, :]), dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_match_jax(dtype):
    n = 40
    a = _rand((n, n + 7), dtype, 8)
    sq = _rand((n, n), dtype, 9)
    a[3, 4] = -0.0
    ta, tsq = torch.from_numpy(a), torch.from_numpy(sq)
    ja, jsq = jnp.asarray(a), jnp.asarray(sq)
    # max is exact: bitwise for real entries; a complex |a| is a rounded
    # hypot, whose formula differs between the frameworks (eps relative)
    maxed = _bitwise if np.isrealobj(a) else (
        lambda got, want: _within(got, want, np.abs(np.asarray(want)), dtype))
    maxed(tto.col_norms(ta), jto.col_norms(ja))
    maxed(tto.genorm(Norm.Max, ta), jto.genorm(JNorm.Max, ja))
    for scope in (NormScope.Columns, NormScope.Rows):
        maxed(tto.genorm(Norm.Max, ta, scope), jto.genorm(JNorm.Max, ja, _jaxenum(scope, JScope)))
        got, want = _np(tto.genorm(Norm.One, ta, scope)), np.asarray(
            jto.genorm(JNorm.One, ja, _jaxenum(scope, JScope)))
        assert np.all(np.abs(got - want) <= a.shape[1] * _eps(dtype) * np.abs(want))

    def close(got, want):
        got, want = float(_np(got)), float(np.asarray(want))
        assert abs(got - want) <= n * _eps(dtype) * abs(want), (got, want)

    for norm in (Norm.One, Norm.Inf, Norm.Fro, Norm.Max):
        jn = _jaxenum(norm, JNorm)
        close(tto.genorm(norm, ta), jto.genorm(jn, ja))
        for uplo in (Uplo.Lower, Uplo.Upper):
            ju = _jaxenum(uplo, JUplo)
            close(tto.henorm(norm, tsq, uplo), jto.henorm(jn, jsq, ju))
            close(tto.synorm(norm, tsq, uplo), jto.synorm(jn, jsq, ju))
            for diag in (Diag.NonUnit, Diag.Unit):
                close(tto.trnorm(norm, ta, uplo, diag),
                      jto.trnorm(jn, ja, ju, _jaxenum(diag, JDiag)))
            close(tto.hbnorm(norm, tsq, uplo, 3), jto.hbnorm(jn, jsq, ju, 3))
        close(tto.gbnorm(norm, ta, 2, 5), jto.gbnorm(jn, ja, 2, 5))
    zero = np.zeros((5, 5), dtype)
    close(tto.genorm(Norm.Fro, torch.from_numpy(zero)), 0.0)  # the zero-scale guard


# ---------------------------------------------------------------------------
# the tile kernels' twins against the interpreted Pallas kernels
# ---------------------------------------------------------------------------

TWIN_DTYPES = {"float32": (torch.float32, jnp.float32, 2.0 ** -23),
               "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)}


def _stack(tdt, seed, nan=True):
    """An (8, 128, 256) stack (mb != nb) in ``tdt``, with a NaN in tile 3."""
    a = _rand((8, 128, 256), np.float32, seed)
    if nan:
        a[3, 5, 7] = np.nan
    return torch.from_numpy(a).to(tdt)


def _jx(t):
    """The same stack as a jax array of the same dtype (bf16 through f32)."""
    jdt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.float().numpy()).astype(jdt)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("name", list(TWIN_DTYPES))
def test_tile_twins_match_interpreted_pallas(name):
    tdt, _, eps = TWIN_DTYPES[name]
    a, b = _stack(tdt, 10), _stack(tdt, 11, nan=False)
    alpha, beta = 0.3, -1.7
    with pltpu.force_tpu_interpret_mode():
        tj = po.transpose_pallas(_jx(a))
        nj = po.genorm_max_pallas(_jx(a))
        gj = po.geadd_pallas(alpha, _jx(a), beta, _jx(b))
    # the twins the wrappers take on a CPU tensor
    tt, nt, gt = tk.transpose_tiles(a), tk.genorm_max_tiles(a), tk.geadd_tiles(alpha, a, beta, b)
    assert tt.shape == (8, 256, 128) and tt.dtype == tdt and nt.dtype == tdt
    np.testing.assert_array_equal(_f32(tt), _f32(tj))  # NaN where NaN
    np.testing.assert_array_equal(_f32(nt), _f32(nj))
    assert np.isnan(_f32(nt)[3]) and np.isfinite(np.delete(_f32(nt), 3)).all()
    # geadd: alpha and beta rounded to the dtype, then within eps (|alpha a| + |beta b|)
    al, be = (float(torch.tensor(x, dtype=tdt)) for x in (alpha, beta))
    a64, b64 = a.double().numpy(), b.double().numpy()
    scale = np.abs(al * a64) + np.abs(be * b64)
    ok = np.isfinite(scale)
    diff = np.abs(_f32(gt).astype(np.float64) - _f32(gj).astype(np.float64))
    assert np.all(diff[ok] <= eps * scale[ok])
    np.testing.assert_array_equal(np.isnan(_f32(gt)), np.isnan(_f32(gj)))


def test_genorm_max_twin_ignores_the_sign_of_zero():
    a = torch.zeros((8, 4, 128))
    a[2] = -0.0
    a[5, 1, 3] = -2.5
    got = tk.genorm_max_tiles(a)
    np.testing.assert_array_equal(got.numpy(), [0, 0, 0, 0, 0, 2.5, 0, 0])
    assert not torch.signbit(got).any()


@pytest.mark.parametrize("shape,dtype,gated", [
    ((8, 128, 128), torch.float32, True),
    ((8, 128, 256), torch.bfloat16, True),
    ((8, 256, 127), torch.float32, False),  # nb < 128
    ((7, 128, 128), torch.float32, False),  # k < 8
    ((8, 128, 128), torch.float64, False),  # dtype
    ((128, 128), torch.float32, False),  # not a stack
    ((2, 4, 4), torch.float32, False),  # tests/test_tile_ops.py's stack
])
def test_use_cuda_tiles_gate(shape, dtype, gated):
    """The gate's rule (tests/test_tile_ops.py's cases for use_pallas_tiles):
    a CUDA tensor, f32/bf16, 3-D, nb >= 128, k >= 8.  Here the shape and
    dtype rule is read on a meta tensor given the card's device type, and
    every CPU tensor is refused."""
    assert tk.use_cuda_tiles(torch.empty(shape, dtype=dtype)) is False
    meta = torch.empty(shape, dtype=dtype, device="meta")
    assert tk.use_cuda_tiles(meta) is False

    class _OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    card = torch.empty(shape, dtype=dtype).as_subclass(_OnCard)
    assert tk.use_cuda_tiles(card) is gated
    assert tk.use_cuda_tiles(np.zeros(shape)) is False


def test_transpose_off_the_gate_is_the_swapped_view():
    a = torch.from_numpy(_rand((8, 128, 128), np.float32, 12))
    before = tk.transpose_tiles.launches
    out = tto.transpose(a)
    assert out.data_ptr() == a.data_ptr() and torch.equal(out, a.transpose(-1, -2))
    assert tk.transpose_tiles.launches == before  # a CPU stack launches nothing
