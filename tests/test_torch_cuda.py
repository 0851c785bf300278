"""The port's CUDA kernels on the card, against their plain twins.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor ``slate_tpu``, so it runs on a machine
that has only PyTorch; tests/conftest.py imports JAX, so run it with
``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the Cholesky factor and inverse hold to the 100 nb eps class
(two summation orders, explicit inverse).  A tile update holds to two
k-ordered FMA sums of nb products, a few sqrt(nb) eps max|a| max|b|, plus
one rounding of the final add each: a TF32 product would fail it.  The
panel solve holds to nb eps |T||X|^T per side plus the two inverses'
difference |T||X_k - X_p|^T, well below its outputs.
"""

import math

import numpy as np
import pytest
import torch

from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.parallel import comm, from_dense, local_view, make_mesh, potrf_dist, to_dense
from slate_tpu_torch.parallel.dryrun import posv_chain, posv_chain_operands
from slate_tpu_torch.utils.testing import generate

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _eps(dtype):
    return torch.finfo(dtype).eps


def _gemm_tol(nb, dtype, c, a, b):
    amax, bmax, cmax = float(a.abs().max()), float(b.abs().max()), float(c.abs().max())
    return 8 * math.sqrt(nb) * _eps(dtype) * amax * bmax + 2 * _eps(dtype) * cmax


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype, device="cuda") * scale


def _stack(mt, nt, nb, dtype, seed, p=2, q=4):
    t = _randn((mt, nt, nb, nb), dtype, seed)
    return t, local_view(t, p, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_diag_inv_kernel_on_card(card, dtype):
    nb = 256
    a = torch.from_numpy(generate("spd", nb, dtype=np.float64, seed=7)).to(dtype).cuda()
    before = tk.chol_diag_inv.launches
    l, x = tk.chol_diag_inv(a)
    torch.cuda.synchronize()
    assert tk.chol_diag_inv.launches == before + 1
    lp, xp = tk.chol_diag_inv_plain(a)
    anorm = float(a.abs().max())
    assert float((l - lp).abs().max()) < 100 * nb * _eps(dtype) * anorm
    assert float((x - xp).abs().max()) < 100 * nb * _eps(dtype) * float(xp.abs().max()) * anorm


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [72, 256])  # 72: ragged against the 64-wide CTA block
@pytest.mark.parametrize("dtype", DTYPES)
def test_update_kernels_match_twins_on_strided_views(card, nb, dtype):
    t, loc = _stack(6, 8, nb, dtype, seed=nb)
    view = loc[:, :, 1:, 1:]  # a bucket's trailing window: (2, 4, 2, 1), strided
    I, J = view.shape[2], view.shape[3]
    pan = _randn((2, 1, I, nb, nb), dtype, 1, 0.1)
    rhs = _randn((1, 4, J, nb, nb), dtype, 2, 0.1)
    _, _, i_log, j_log = comm.local_indices(2, 4, 3, 2, "cuda", 1, 1)
    mask = i_log[:, :, :, None] >= j_log[:, :, None, :]
    base = view.clone()
    for name, run, plain in (
            ("summa_update", lambda v: tk.summa_update(v, pan, rhs),
             lambda v: tk.summa_update_plain(v, pan, rhs)),
            ("chol_trailing_update", lambda v: tk.chol_trailing_update(v, pan, rhs, mask),
             lambda v: tk.chol_trailing_update_plain(v, pan, rhs, mask))):
        counter = getattr(tk, name)
        before = counter.launches
        view.copy_(base)
        run(view)
        torch.cuda.synchronize()
        got = view.clone()
        assert counter.launches == before + 1
        view.copy_(base)
        plain(view)
        cmax = torch.maximum(base.abs(), view.abs())
        assert float((got - view).abs().max()) < _gemm_tol(nb, dtype, cmax, pan, rhs)
    # masked tiles are neither read nor written
    assert torch.equal(got[~mask], base[~mask])
    # nothing outside the window moved
    assert torch.equal(loc[:, :, 0], local_view(t, 2, 4)[:, :, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_single_column_launch_is_bitwise_the_full_launch(card, dtype):
    # the lookahead narrow refresh (J = 1) and the bulk update give every
    # element the same bits: the kernel's order does not depend on the grid
    nb = 256
    _, loc = _stack(4, 8, nb, dtype, seed=3)
    pan = _randn((2, 1, 2, nb, nb), dtype, 4)
    rhs = _randn((1, 4, 2, nb, nb), dtype, 5)
    mask = torch.ones((2, 4, 2, 2), dtype=torch.bool, device="cuda")
    full = loc.clone()
    tk.chol_trailing_update(full, pan, rhs, mask)
    col = loc.clone()
    tk.chol_trailing_update(col[:, :, :, 1:2], pan, rhs[:, :, 1:2], mask[:, :, :, 1:2])
    torch.cuda.synchronize()
    assert torch.equal(col[:, :, :, 1], full[:, :, :, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_panel_tiles_kernel_on_a_strided_panel(card, dtype):
    nb = 256
    _, loc = _stack(8, 8, nb, dtype, seed=6)
    pcol = loc[:, 1:2, :, 1]  # the owning column's panel: (2, 1, 4, nb, nb)
    d = torch.from_numpy(generate("spd", nb, dtype=np.float64, seed=8)).to(dtype).cuda()
    before = tk.chol_panel_tiles.launches
    l, s = tk.chol_panel_tiles(d, pcol)
    torch.cuda.synchronize()
    assert tk.chol_panel_tiles.launches == before + 1
    lp, sp = tk.chol_panel_tiles_plain(d, pcol)
    _, xk = tk.chol_diag_inv(d)  # the L^-1 the panel kernel solved with
    _, xp = tk.chol_diag_inv_plain(d)
    assert float((l - lp).abs().max()) < 100 * nb * _eps(dtype) * float(d.abs().max())
    t = pcol.abs()
    tol_s = float((nb * _eps(dtype) * (t @ xk.abs().T + t @ xp.abs().T) + t @ (xk - xp).abs().T).max())
    assert tol_s < 1e-2 * float(sp.abs().max())  # a wrong output cannot pass
    assert float((s - sp).abs().max()) < tol_s


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(card):
    v = torch.zeros((1, 1, 1, 1, 8, 8), dtype=torch.bfloat16, device="cuda")
    p = torch.zeros((1, 1, 1, 8, 8), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError, match="not supported on CUDA"):
        tk.summa_update(v, p, p)
    with pytest.raises(ValueError, match="share device and dtype"):
        tk.summa_update(v.float(), p.double(), p.float())
    with pytest.raises(ValueError, match="chol_panel_tiles"):
        tk.chol_panel_tiles(torch.zeros((300, 300), device="cuda"), torch.zeros((2, 300, 300), device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_potrf_dist_on_card_against_the_host(card, dtype):
    n, nb = 1000, 64  # 16 tiles, padded from 15.6
    a = torch.from_numpy(generate("spd", n, dtype=np.float64, seed=12)).to(dtype)
    res = {}
    for dev in ("cpu", "cuda"):
        mesh = make_mesh(2, 4, device=dev)
        runs = [potrf_dist(from_dense(a, mesh, nb, diag_pad_one=True), lookahead=la) for la in (0, 1, 2)]
        for l, info in runs:
            assert int(info) == 0
            assert torch.equal(l.tiles, runs[0][0].tiles)  # bitwise at every depth
        res[dev] = to_dense(runs[0][0]).cpu().tril()
    assert float((res["cuda"] - res["cpu"]).abs().max()) < 100 * n * _eps(dtype) * float(a.abs().max())


@pytest.mark.cuda
def test_posv_chain_on_card(card):
    a, b = posv_chain_operands()
    _, info, eta = posv_chain(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(),
                              make_mesh(2, 4, device="cuda"))
    assert int(info) == 0 and eta < 100 * 64 * _eps(torch.float32)
