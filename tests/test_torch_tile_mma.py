"""The blocking of the tile-GEMM core (csrc/tile_mma.cuh, and its two kernels
csrc/tile_gemm.cu and csrc/ft_summa_update.cu), modelled in PyTorch on the CPU
and held against the plain twins of ``slate_tpu_torch.ops.kernels`` and
against ``slate_tpu``'s Pallas update kernels run in interpret mode.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against the same twins there).  This file rehearses
their algorithm here: the BM x BN x BK walk of each CTA over a tile pair, the
zero-filled loads off a ragged tile (any nb >= 1), stride-0 shared operands,
both B forms (N: op(B) = B; T: op(B) = B^T), the three modes applied once
after the sum, the mask skip (a masked tile is never read or written, so a
NaN there stays), ft_summa_update's in-order loop over the tile rows i with
its two weighted sums, and the wrapper's 16-byte load predicate.  The block
shapes are read from the header, so the model follows the source.

The model sums each output element's products in k order as the card does:
f32 one fused multiply-add per product (modelled in f64 and rounded to f32
once: the product of two f32 values is exact in f64), f64 one 16-deep step per
m16n8k16 DMMA.  Tolerance: the twin sums the same nb products in another
order, so kernel and twin differ by two k-ordered sums' rounding errors,
which grow as a random walk (a few sqrt(nb) eps max|a| max|b|), plus one
rounding each of the final add or subtract: 8 sqrt(nb) eps max|a| max|b| +
2 eps max|c| (chip_smoke.py's gemm_tol).  A TF32 product lies far outside
it.  Masked tiles and NaN patterns are held exactly.
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import pallas_ops as po
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.ops import _build

NBS = [1, 7, 8, 31, 33, 100, 127, 128, 129, 200, 256]
DTYPES = [torch.float32, torch.float64]


def _header():
    with open(os.path.join(_build.CSRC_DIR, "tile_mma.cuh")) as f:
        return f.read()


def _cfg(dtype, *keys):
    """Constants of Cfg<float, BN> / Cfg<double, 64> in csrc/tile_mma.cuh."""
    name = r"float, BN" if dtype == torch.float32 else r"double, 64"
    body = re.search(r"struct Cfg<%s> \{(.*?)\};" % name, _header(), re.S).group(1)
    return tuple(int(re.search(r"\b%s = (\d+)" % k, body).group(1)) for k in keys)


def _block(dtype, kernel="gemm"):
    """(BM, BN, BK) of the kernel's CTA (tile_gemm: kGemmBN columns,
    ft_summa_update: kFtBN): its output block and the k depth of a chunk."""
    bm, bk = _cfg(dtype, "kBM", "kBK")
    if dtype == torch.float64:
        return bm, _cfg(dtype, "kBN")[0], bk
    src = _header()
    if kernel == "gemm":
        bn = int(re.search(r"kGemmBN = sizeof\(T\) == 4 \? (\d+)", src).group(1))
    else:
        bn = int(re.search(r"constexpr int kFtBN = (\d+);", src).group(1))
    return bm, bn, bk


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _pad(x, rows, cols):
    out = torch.zeros(x.shape[:-2] + (rows, cols), dtype=x.dtype)
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


def model_core(a, opb, kernel="gemm"):
    """One CTA walk per BM x BN block of A . op(B) over a batch of nb x nb
    tile pairs: the loads zero-fill off the tile, the k-chunks of BK run in
    order, and inside a chunk f32 takes one FMA per product, f64 one
    16-deep DMMA step.  Returns the nb x nb products."""
    bm, bn, bk = _block(a.dtype, kernel)
    nb = a.shape[-1]
    mp, np_, kp = (-(-nb // s) * s for s in (bm, bn, bk))
    ap, bp = _pad(a, mp, kp), _pad(opb, kp, np_)
    # blocks: (..., mb, BM, kp) and (..., kp, nbk, BN)
    ab = ap.reshape(ap.shape[:-2] + (mp // bm, 1, bm, kp))
    bb = bp.reshape(bp.shape[:-2] + (kp, np_ // bn, bn)).movedim(-2, -3).unsqueeze(-4)
    (step,) = _cfg(a.dtype, "kMmaK")
    acc = 0  # (..., mb, nbk, BM, BN) after the first step
    for k0 in range(0, kp, bk):
        for k in range(k0, k0 + bk, step):
            prod = ab[..., k:k + step].double() @ bb[..., k:k + step, :].double()
            if a.dtype == torch.float32:
                acc = (acc + prod).float().double()  # one FFMA: exact product, one rounding
            else:
                acc = acc + prod
    out = acc.transpose(-3, -2).reshape(acc.shape[:-4] + (mp, np_))
    return out[..., :nb, :nb].to(a.dtype)


def model_tile_gemm(c, a, b, mask, trans_b, mode):
    """The tile_gemm launch: c (R, Q, I, J, nb, nb) (=, +=, -=) A[i] op(B[j])
    on every unmasked tile, masked tiles untouched, in place."""
    R, Q, I, J = c.shape[:4]
    nb = c.shape[-1]
    a = a.expand(R, Q, I, nb, nb).unsqueeze(3)
    b = b.expand(R, Q, J, nb, nb).unsqueeze(2)
    upd = model_core(a, b.transpose(-1, -2) if trans_b else b)
    new = upd if mode == "set" else (c + upd if mode == "add" else c - upd)
    keep = torch.ones((R, Q, I, J), dtype=torch.bool)
    if mask is not None:
        keep = mask.expand(R, Q, I, J) != 0
    c.copy_(torch.where(keep[..., None, None], new, c))
    return c


def model_ft(acc, pan, urow, w1, w2, part):
    """The ft_summa_update launch: per output column j, the products of
    i = 0 .. I-1 in order, each added to acc[i, j] and, weighted, to the two
    running sums (a rounded product, then a rounded add); after the loop the
    sums go into part[:, j]."""
    R, Q, I, J, nb, _ = acc.shape
    pan = pan.expand(R, Q, I, nb, nb)
    urow = urow.expand(R, Q, J, nb, nb)
    w = [x.expand(R, Q, I) for x in (w1, w2)]
    s = [torch.zeros((R, Q, J, nb, nb), dtype=acc.dtype) for _ in range(2)]
    for i in range(I):
        upd = model_core(pan[:, :, i:i + 1], urow, "ft")  # (R, Q, J, nb, nb)
        acc[:, :, i] += upd
        for t in range(2):
            s[t] = s[t] + w[t][:, :, i, None, None, None] * upd
    for t in range(2):
        part[:, :, t] += s[t]
    return acc, part


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _eps(dtype):
    return torch.finfo(dtype).eps


def _tol(nb, dtype, a, b, *cs):
    cmax = max(float(c.abs().max()) for c in cs)
    return (8 * math.sqrt(nb) * _eps(dtype) * float(a.abs().max()) * float(b.abs().max())
            + 2 * _eps(dtype) * cmax)


def _randn(rng, shape, dtype, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


# ---------------------------------------------------------------------------
# the source and the model
# ---------------------------------------------------------------------------


def test_block_shapes_are_the_headers():
    # f32 128 x 128 (8 x 8 per thread of 256, one FFMA per product; the ft
    # kernel 128 x 64, 8 x 4), f64 64 x 64 (128 threads, m16n8k16 DMMA);
    # BK = 16 in both, whole MMAs
    assert _block(torch.float32) == (128, 128, 16)
    assert _block(torch.float32, "ft") == (128, 64, 16)
    assert _block(torch.float64) == _block(torch.float64, "ft") == (64, 64, 16)
    assert _cfg(torch.float32, "kMmaK") == (1,) and _cfg(torch.float64, "kMmaK") == (16,)
    for dt in DTYPES:
        assert _block(dt)[2] % _cfg(dt, "kMmaK")[0] == 0


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["N", "T"])
def test_core_model_matches_twin(nb, dtype, form):
    # a (1, 2, 2, 1) grid of ragged tiles: the A panel is shared by both
    # mesh columns through stride 0
    rng = np.random.default_rng(nb)
    c = _randn(rng, (1, 2, 2, 1, nb, nb), dtype)
    pan = _randn(rng, (1, 1, 2, nb, nb), dtype, 0.5)
    rhs = _randn(rng, (1, 2, 1, nb, nb), dtype, 0.5)
    mask = torch.ones((1, 2, 2, 1), dtype=torch.int32)
    got = model_tile_gemm(c.clone(), pan, rhs, mask, form == "T", "sub")
    if form == "T":
        want = tk.chol_trailing_update_plain(c.clone(), pan, rhs, mask)
    else:
        want = tk.lu_trailing_update_plain(c.clone(), pan, rhs, mask)
    assert float((got - want).abs().max()) <= _tol(nb, dtype, pan, rhs, c, want)


_CALLERS = ["summa_update", "chol_trailing_update", "lu_trailing_update", "chol_panel_tiles",
            "lu_panel_tiles", "lu_rowsolve_tiles"]


@pytest.mark.parametrize("who", _CALLERS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_each_caller_form_against_its_twin(who, dtype):
    """The six launch forms of tile_gemm (mode, B form, mask, which operand
    is shared) at a ragged nb against the wrappers' twins on CPU tensors;
    masked tiles, NaN included, come back bitwise as they were."""
    nb = 72
    rng = np.random.default_rng(len(who))
    if who in ("summa_update", "chol_trailing_update", "lu_trailing_update"):
        c = _randn(rng, (2, 4, 3, 2, nb, nb), dtype)
        pan = _randn(rng, (2, 1, 3, nb, nb), dtype, 0.1)
        rhs = _randn(rng, (1, 4, 2, nb, nb), dtype, 0.1)
        mask = torch.from_numpy(rng.random((2, 4, 3, 2)) < 0.6)
        c[~mask] = float("nan")  # masked tiles hold NaN (a potrf breakdown)
        pan[0, 0, 0, 3, 5] = float("nan")  # and a NaN row reaches only its outputs
        trans, mode = who == "chol_trailing_update", "add" if who == "summa_update" else "sub"
        m = None if who == "summa_update" else mask
        got = model_tile_gemm(c.clone(), pan, rhs, m, trans, mode)
        twin = getattr(tk, who)
        want = twin(c.clone(), pan, rhs) if m is None else twin(c.clone(), pan, rhs, mask)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        live = torch.isfinite(want)
        tol = _tol(nb, dtype, pan[torch.isfinite(pan)], rhs, c[torch.isfinite(c)], want[live])
        assert float((got[live] - want[live]).abs().max()) <= tol
        if m is not None:
            assert torch.equal(_bits(got[~mask]), _bits(c[~mask]))
        return
    # the panel solves: mode set with a shared operand, through the twins'
    # own inverses
    d = _randn(rng, (nb, nb), torch.float64) + nb * torch.eye(nb, dtype=torch.float64)
    tiles = _randn(rng, (2, 1, 3, nb, nb), dtype)
    if who == "chol_panel_tiles":
        d = (d @ d.T / nb).to(dtype)
        _, x = tk.chol_diag_inv_plain(d)
        got = model_tile_gemm(torch.empty(2, 1, 3, 1, nb, nb, dtype=dtype), tiles,
                              x[None, None, None], None, True, "set")[:, :, :, 0]
        want = tk.chol_panel_tiles_plain(d, tiles)[1]
    elif who == "lu_panel_tiles":
        d = d.to(dtype)
        _, x = tk.lu_diag_inv_plain(d)
        got = model_tile_gemm(torch.empty(2, 1, 3, 1, nb, nb, dtype=dtype), tiles,
                              x[None, None, None], None, False, "set")[:, :, :, 0]
        want = tk.lu_panel_tiles_plain(d, tiles)[1]
    else:
        d = d.to(dtype)
        lu, _ = tk.lu_diag_inv_plain(d)
        x = tk.unit_linv_plain(lu)
        got = model_tile_gemm(torch.empty(2, 1, 1, 3, nb, nb, dtype=dtype), x[None, None, None],
                              tiles, None, False, "set")[:, :, 0]
        want = tk.lu_rowsolve_tiles_plain(lu, tiles)
    assert float((got - want).abs().max()) <= _tol(nb, dtype, tiles, x, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_column_alone_gets_the_bits_of_the_full_launch(dtype):
    # the walk never depends on the grid: the lookahead narrow refresh (J = 1)
    # and the bulk update give every element the same bits
    nb = 100
    rng = np.random.default_rng(5)
    c = _randn(rng, (2, 4, 2, 3, nb, nb), dtype)
    pan = _randn(rng, (2, 1, 2, nb, nb), dtype)
    rhs = _randn(rng, (1, 4, 3, nb, nb), dtype)
    full = model_tile_gemm(c.clone(), pan, rhs, None, True, "sub")
    col = model_tile_gemm(c[:, :, :, 1:2].clone(), pan, rhs[:, :, 1:2], None, True, "sub")
    assert torch.equal(col[:, :, :, 0], full[:, :, :, 1])


@pytest.mark.parametrize("nb", [1, 7, 33, 129])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ft_model_matches_twin(nb, dtype):
    from slate_tpu_torch.utils.testing import ft_summa_check

    rng = np.random.default_rng(nb + 1)
    R, Q, I, J = 2, 4, 3, 2
    acc = _randn(rng, (R, Q, I, J, nb, nb), dtype, 10.0)
    pan = _randn(rng, (R, 1, I, nb, nb), dtype)
    urow = _randn(rng, (1, Q, J, nb, nb), dtype)
    part = _randn(rng, (R, Q, 2, J, nb, nb), dtype, 100.0)
    w1 = torch.tensor([[[1.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]]], dtype=dtype)  # zero on checksum rows
    w2 = w1 * torch.arange(1, I + 1, dtype=dtype)
    got = model_ft(acc.clone(), pan, urow, w1, w2, part.clone())
    want = tk.ft_summa_update_plain(acc.clone(), pan, urow, w1, w2, part.clone())
    readings = ft_summa_check(acc, pan, urow, w1, w2, part, got, want)
    assert all(v <= 1 for v in readings.values()), readings
    # a zeroed part must fail its reading: the check can see a wrong sum
    bad = ft_summa_check(acc, pan, urow, w1, w2, part, (got[0], torch.zeros_like(got[1])), want)
    assert bad["part0"] > 1 and bad["part1"] > 1


# ---------------------------------------------------------------------------
# the model against slate_tpu's Pallas update kernels (interpret mode, nb = 8)
# ---------------------------------------------------------------------------


def _pallas_operands(dtype, seed, mtl=3, ntl=4, nb=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((mtl, ntl, nb, nb)), rng.standard_normal((mtl, nb, nb)),
            rng.standard_normal((ntl, nb, nb)), np.arange(mtl)[:, None] >= np.arange(ntl)[None, :])


_NP = {torch.float32: np.float32, torch.float64: np.float64}


@pytest.mark.parametrize("which", ["summa_update", "chol_trailing_update", "lu_trailing_update"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_core_model_matches_pallas_update(which, dtype):
    acc, pan, rhs, lower = _pallas_operands(dtype, seed=len(which))
    npd = _NP[dtype]
    j = [jnp.asarray(x.astype(npd)) for x in (acc, pan, rhs)]
    if which == "summa_update":
        ref = po.summa_update_pallas(*j)
    else:
        ref = getattr(po, f"{which}_pallas")(*j, jnp.asarray(lower))
    t = [torch.from_numpy(x.astype(npd)) for x in (acc, pan, rhs)]
    mask = None if which == "summa_update" else torch.from_numpy(lower)[None, None].int()
    got = model_tile_gemm(t[0][None, None].clone(), t[1][None, None], t[2][None, None], mask,
                          which == "chol_trailing_update",
                          "add" if which == "summa_update" else "sub")[0, 0]
    ref = torch.from_numpy(np.array(ref))
    assert float((got - ref).abs().max()) <= _tol(8, dtype, t[1], t[2], t[0], ref)
    if mask is not None:  # masked tiles exactly the reference's (a - 0)
        keep = ~torch.from_numpy(lower)
        assert torch.equal(got[keep], ref[keep])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ft_model_matches_pallas(dtype):
    from slate_tpu_torch.utils.testing import ft_summa_check

    rng = np.random.default_rng(42)
    I, J, nb = 4, 3, 8
    npd = _NP[dtype]
    acc, pan, urow = (rng.standard_normal(s).astype(npd) for s in ((I, J, nb, nb), (I, nb, nb),
                                                                    (J, nb, nb)))
    w1 = np.array([1, 1, 1, 0], dtype=npd)
    w2 = np.array([1, 2, 3, 0], dtype=npd)
    part0 = rng.standard_normal((2, J, nb, nb)).astype(npd)
    ref = tuple(torch.from_numpy(np.array(v)) for v in po.ft_summa_update_pallas(
        *(jnp.asarray(x) for x in (acc, pan, urow, w1, w2, part0))))
    t = [torch.from_numpy(x)[None, None] for x in (acc, pan, urow, w1, w2, part0)]
    got = model_ft(t[0].clone(), t[1], t[2], t[3], t[4], t[5].clone())
    readings = ft_summa_check(t[0], t[1], t[2], t[3], t[4], t[5], got,
                              (ref[0][None, None], ref[1][None, None]))
    assert all(v <= 1 for v in readings.values()), readings


# ---------------------------------------------------------------------------
# the wrapper's 16-byte load predicate
# ---------------------------------------------------------------------------

# (shape, strides, byte offset of the base, itemsize, nb, 16-byte loads)
_LOAD16 = [
    ((2, 4, 8, 256, 256), (0, 0, 65536, 256, 1), 0, 4, 256, True),  # a stride-0 panel
    ((2, 4, 8, 256, 256), (0, 0, 65536, 256, 1), 4, 4, 256, False),  # offset by one f32
    ((2, 4, 8, 256, 256), (0, 0, 65536, 256, 1), 16, 4, 256, True),  # offset by 16 bytes
    ((2, 4, 8, 256, 256), (0, 0, 65536, 256, 1), 8, 8, 256, False),  # offset by one f64
    ((2, 4, 8, 72, 72), (0, 0, 5184, 72, 1), 0, 4, 72, True),  # ragged block, whole vectors
    ((2, 4, 8, 7, 7), (0, 0, 49, 7, 1), 0, 4, 7, False),  # nb not a multiple of the vector
    ((2, 4, 8, 6, 6), (0, 0, 36, 6, 1), 0, 8, 6, True),  # f64: two per vector
    ((2, 4, 8, 6, 6), (0, 0, 36, 6, 1), 0, 4, 6, False),  # f32: 6 is not 4 k
    ((2, 4, 8, 256, 256), (0, 0, 65536, 1, 256), 0, 4, 256, False),  # transposed: column stride 256
    ((2, 4, 8, 256, 256), (0, 0, 65538, 256, 1), 0, 4, 256, False),  # a tile stride off the vector
    ((1, 1, 1, 256, 256), (7, 3, 5, 256, 1), 0, 4, 256, True),  # strides of length-1 dims unread
    ((2, 4, 8, 8, 8), (2048, 512, 64, 8, 1), 0, 4, 8, True),
    ((2, 4, 8, 8, 8), (2048, 514, 64, 8, 1), 0, 4, 8, False),  # a mesh-column stride off the vector
]


@pytest.mark.parametrize("shape,strides,offset,itemsize,nb,want", _LOAD16)
def test_load16_predicate(shape, strides, offset, itemsize, nb, want):
    assert tk.load16(shape, strides, 1 << 20 | offset, itemsize, nb) is want


@pytest.mark.parametrize("dtype", DTYPES)
def test_load16_reads_the_panel_views_of_the_mesh_factorizations(dtype):
    # the owning column's and row's panels of a cyclic stack, as the mesh
    # factorizations slice them and the wrappers broadcast them, are 16-byte
    # loadable; the same views one element off are not
    from slate_tpu_torch.parallel import local_view

    nb, n = 16, 8 * 24 * 16 * 16
    t = torch.zeros((n + 1,), dtype=dtype)
    assert t.data_ptr() % 16 == 0
    for off, want in ((0, True), (1, False)):
        loc = local_view(t[off:off + n].view(8, 24, nb, nb), 2, 4)
        for v in (loc[:, 1:2, :, 1], loc[1:2, :, 1]):
            assert bool(tk._load16(v.expand(2, 4, *v.shape[2:]), nb)) is want
