"""The port's CUDA kernels on the card, against their plain twins.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor ``slate_tpu``, so it runs on a machine
that has only PyTorch; tests/conftest.py imports JAX, so run it with
``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the Cholesky factor holds to the twin at L's own scale (100 nb
eps max|L|) and to A by reconstruction, L L^T = A within 3 nb eps |L||L^T|
elementwise; its inverse to the twin at its own scale and to L X = I the
same way.  The packed LU holds L and U
each at its own scale, and to A by reconstruction within 3 nb eps |L||U|
elementwise; its inverses hold to U X = I and L Y = I the same way.  A tile update holds to two
k-ordered FMA sums of nb products, a few sqrt(nb) eps max|a| max|b|, plus
one rounding of the final add each: a TF32 product would fail it.  The
panel solve holds to nb eps |T||X|^T per side plus the two inverses'
difference |T||X_k - X_p|^T, well below its outputs.  A Householder panel
never holds its packed factor to one limit (``utils.testing.qr_panel_check``):
R's pivots, R's other entries, V below its pivots, tau and T's off-diagonal
each hold to the twin within 2 m eps of their own largest entry, Q R = A
(Q = I - V T V^T, in f64) within m eps max|A|, and the compact-WY identity
T (V^T V) T^T = T + T^T within m eps max|T|.  A least-squares solve holds
to the componentwise normal-equations residual (``gels_omega``, in f64)
below 20 eps / sqrt(m).
"""

import math

import numpy as np
import pytest
import torch

from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.parallel import comm, from_dense, local_view, make_mesh, potrf_dist, to_dense
from slate_tpu_torch.parallel.dryrun import posv_chain, posv_chain_operands
from slate_tpu_torch.utils.testing import (
    QR_EDGE_OFFSET,
    QR_EDGE_OFFSET_GLOBAL,
    QR_EDGE_VARIANTS,
    generate,
    gels_omega,
    gels_omega_gate,
    qr_edge_checks,
    qr_edge_panel,
    qr_edge_plain,
    qr_edge_row0s,
    qr_panel_check,
    qr_panel_mutants,
    qr_panel_ok,
    qr_rows_in_global,
)

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

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


def _check_chol_factor(a, l, lp):
    """The kernel's L: to the twin within 100 nb eps of L's own largest
    entry (a limit below 1e-2 of it), and L L^T = A by reconstruction
    within 3 nb eps |L||L^T| elementwise (``_residual_ratio``)."""
    nb, eps = a.shape[-1], _eps(a.dtype)
    scale = float(lp.abs().max())
    assert 100 * nb * eps < 1e-2
    assert float((l - lp).abs().max()) < 100 * nb * eps * scale
    assert _residual_ratio(l, l.T, a) <= 1


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
    _check_chol_factor(a, l, lp)
    # L^-1: to the twin at its own scale, and L X = I by residual
    assert float((x - xp).abs().max()) < 100 * nb * _eps(dtype) * float(xp.abs().max())
    assert _residual_ratio(l, x, torch.eye(nb, dtype=dtype, device="cuda")) <= 1


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
    _check_chol_factor(d, l, lp)
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


# ---------------------------------------------------------------------------
# the LU kernels (csrc/lu_diag_inv.cu, and the tile-GEMM in their geometries)
# ---------------------------------------------------------------------------


def _lu_block(nb, dtype, seed):
    """A block that factors stably without pivoting: randn + nb I."""
    g = np.random.default_rng(seed).standard_normal((nb, nb)) + nb * np.eye(nb)
    return torch.from_numpy(g).to(dtype).cuda()


def _solve_tol(eps, nb, left, right_k, right_p, left_side):
    """|T X_k - T X_p| (or |X_k T - X_p T|) as two k-ordered sums of nb
    products plus the inverses' own difference; elementwise, the largest."""
    t = left.abs()
    if left_side:  # X @ T
        return float((nb * eps * (right_k.abs() @ t + right_p.abs() @ t)
                      + (right_k - right_p).abs() @ t).max())
    return float((nb * eps * (t @ right_k.abs() + t @ right_p.abs()) + t @ (right_k - right_p).abs()).max())


def _residual_ratio(lhs, rhs, want):
    """max |lhs @ rhs - want| / (3 nb eps |lhs||rhs|), the product in f64:
    at most 1 for a factor or triangular inverse computed in any summation
    order (the backward error bound gamma_nb, unit roundoff eps / 2, plus
    the check's own product, with room).  0/0 reads 0."""
    nb, eps = lhs.shape[-1], _eps(lhs.dtype)
    l64, r64 = lhs.double(), rhs.double()
    res = (l64 @ r64 - want.double()).abs()
    return float(torch.nan_to_num(res / (3 * nb * eps * (l64.abs() @ r64.abs())), nan=0.0,
                                  posinf=float("inf")).max())


def _check_lu_factor(a, lu, lup):
    """The kernel's packed L\\U: L (strict lower) and U (upper) each within
    100 nb eps of the twin's largest entry of that factor (L's entries are
    ~1/nb of U's: one limit for both would pass a zero L), each limit below
    1e-2 of what it holds, and L U = A by reconstruction (which also holds
    U's off-diagonal entries, far below its diagonal)."""
    nb, eps = a.shape[-1], _eps(a.dtype)
    for part in (lambda m: m.tril(-1), lambda m: m.triu()):
        scale = float(part(lup).abs().max())
        assert 100 * nb * eps < 1e-2
        assert float((part(lu) - part(lup)).abs().max()) < 100 * nb * eps * scale
    eye = torch.eye(nb, dtype=a.dtype, device=a.device)
    assert _residual_ratio(lu.tril(-1) + eye, lu.triu(), a) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [72, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_diag_inv_and_unit_linv_on_card(card, nb, dtype):
    # the kernel's two entry points through their wrappers, applied to the
    # identity: I U^-1 and L^-1 I are exact for finite inverses
    a = _lu_block(nb, dtype, nb)
    eye = torch.eye(nb, dtype=dtype, device="cuda")
    counts = (tk.lu_panel_tiles.launches, tk.lu_rowsolve_tiles.launches)
    lu, x = tk.lu_panel_tiles(a, eye[None])
    linv = tk.lu_rowsolve_tiles(lu, eye[None])[0]
    x = x[0]
    torch.cuda.synchronize()
    assert (tk.lu_panel_tiles.launches, tk.lu_rowsolve_tiles.launches) == (counts[0] + 1, counts[1] + 1)
    lup, xp = tk.lu_diag_inv_plain(a)
    linvp = tk.unit_linv_plain(lup)
    eps = _eps(dtype)
    _check_lu_factor(a, lu, lup)
    # each inverse: to the twin at its own scale, and U X = I, L Y = I by residual
    assert float((x - xp).abs().max()) < 100 * nb * eps * float(xp.abs().max())
    assert float((linv - linvp).abs().max()) < 100 * nb * eps * float(linvp.abs().max())
    assert _residual_ratio(lu.triu(), x, eye) <= 1
    assert _residual_ratio(lu.tril(-1) + eye, linv, eye) <= 1
    assert torch.equal(x.tril(-1), torch.zeros_like(x)) and torch.equal(linv.triu(1), torch.zeros_like(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_diag_inv_zero_pivot_pattern_on_card(card, dtype):
    # a zero pivot divides by 1 in the factor (finite) and by the raw 0 in
    # U^-1: the same non-finite pattern as the twin (slate_tpu's body)
    nb, j = 64, 17
    a = _lu_block(nb, dtype, 3)
    a[j, :] = 0
    lu, x = torch.empty_like(a), torch.empty_like(a)
    tk._launch_lu("lu_diag_inv", "test", a, lu, x)  # the entry point itself: U^-1 unsmeared
    lup, xp = tk.lu_diag_inv_plain(a)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(lu).all()) and float(lu[j, j]) == 0.0
    assert torch.equal(torch.isfinite(x), torch.isfinite(xp))
    assert not bool(torch.isfinite(x[: j + 1].triu()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_panel_and_rowsolve_kernels_on_strided_tiles(card, dtype):
    nb = 256
    eps = _eps(dtype)
    _, loc = _stack(8, 8, nb, dtype, seed=9)
    pcol = loc[:, 1:2, :, 1]  # the owning column's panel: (2, 1, 4, nb, nb)
    prow = loc[1:2, :, 2]  # the owning row's panel: (1, 4, 2, nb, nb)
    d = _lu_block(nb, dtype, 10)
    before = (tk.lu_panel_tiles.launches, tk.lu_rowsolve_tiles.launches)
    lu, s = tk.lu_panel_tiles(d, pcol)
    r = tk.lu_rowsolve_tiles(lu, prow)
    torch.cuda.synchronize()
    assert (tk.lu_panel_tiles.launches, tk.lu_rowsolve_tiles.launches) == (before[0] + 1, before[1] + 1)
    lup, sp = tk.lu_panel_tiles_plain(d, pcol)
    rp = tk.lu_rowsolve_tiles_plain(lu, prow)
    eye = torch.eye(nb, dtype=dtype, device="cuda")[None]
    xk = tk.lu_panel_tiles(d, eye)[1][0]  # the U^-1 the panel kernel solved with
    _, xp = tk.lu_diag_inv_plain(d)
    _check_lu_factor(d, lu, lup)
    tol_s = _solve_tol(eps, nb, pcol, xk, xp, left_side=False)
    assert tol_s < 1e-2 * float(sp.abs().max())  # a wrong output cannot pass
    assert float((s - sp).abs().max()) < tol_s
    lk, lp = tk.lu_rowsolve_tiles(lu, eye)[0], tk.unit_linv_plain(lu)
    tol_r = _solve_tol(eps, nb, prow, lk, lp, left_side=True)
    assert tol_r < 1e-2 * float(rp.abs().max())
    assert float((r - rp).abs().max()) < tol_r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_trailing_update_matches_twin_on_a_strided_window(card, dtype):
    nb = 256
    _, loc = _stack(6, 8, nb, dtype, seed=11)
    view = loc[:, :, 1:, 1:]  # (2, 4, 2, 1)
    pan = _randn((2, 1, 2, nb, nb), dtype, 12, 0.1)
    urow = _randn((1, 4, 1, nb, nb), dtype, 13, 0.1)
    mask = torch.tensor([[True], [False]], device="cuda")[None, None]  # the lookahead exclusion
    base = view.clone()
    before = tk.lu_trailing_update.launches
    tk.lu_trailing_update(view, pan, urow, mask)
    torch.cuda.synchronize()
    assert tk.lu_trailing_update.launches == before + 1
    got = view.clone()
    view.copy_(base)
    tk.lu_trailing_update_plain(view, pan, urow, mask)
    cmax = torch.maximum(base.abs(), view.abs())
    assert float((got - view).abs().max()) < _gemm_tol(nb, dtype, cmax, pan, urow)
    assert torch.equal(got[:, :, 1], base[:, :, 1])  # the masked row slot is untouched


@pytest.mark.cuda
def test_lu_wrappers_raise_instead_of_falling_back(card):
    half = torch.zeros((8, 8), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError, match="not supported on CUDA"):
        tk.lu_panel_tiles(half, half[None])
    with pytest.raises(ValueError, match="lu_panel_tiles"):
        tk.lu_panel_tiles(torch.zeros((300, 300), device="cuda"), torch.zeros((2, 300, 300), device="cuda"))
    with pytest.raises(ValueError, match="share device and dtype"):
        tk.lu_rowsolve_tiles(torch.zeros((8, 8), device="cuda"), torch.zeros((2, 8, 8), dtype=torch.float64,
                                                                              device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["nopiv", "pp", "tntpiv"])
def test_mesh_lu_on_card_bitwise_across_lookahead(card, form):
    from slate_tpu_torch.parallel import getrf_nopiv_dist, getrf_pp_dist, getrf_tntpiv_dist

    n, nb = 1000, 64  # 16 tiles, padded from 15.6
    g = np.random.default_rng(21).standard_normal((n, n))
    if form == "nopiv":
        g += n * np.eye(n)
    a = torch.from_numpy(g).float()
    fn = {"nopiv": getrf_nopiv_dist, "pp": getrf_pp_dist, "tntpiv": getrf_tntpiv_dist}[form]
    mesh = make_mesh(2, 4, device="cuda")
    runs = [fn(from_dense(a, mesh, nb, diag_pad_one=True), lookahead=la) for la in (0, 1, 2)]
    for out in runs:
        assert int(out[-1]) == 0
        assert torch.equal(out[0].tiles, runs[0][0].tiles)
        if form != "nopiv":
            assert torch.equal(out[1], runs[0][1])
    lu = to_dense(runs[0][0]).double().cpu()
    rec = (lu.tril(-1) + torch.eye(n, dtype=torch.float64)) @ lu.triu()
    ap = g if form == "nopiv" else np.pad(g, ((0, 24), (0, 0)))[runs[0][1].cpu().numpy()][:n]
    assert float((rec - torch.from_numpy(ap)).abs().max()) < 100 * n * _eps(torch.float32) * float(np.abs(g).max())


# ---------------------------------------------------------------------------
# the blocked diagonal-block kernels over n, dtype and entry
# (csrc/diag_block.cuh: 32-wide panels, a ragged last panel padded)
# ---------------------------------------------------------------------------

DIAG_NS = [1, 7, 31, 32, 33, 72, 200, 256]
# a bad column in the first panel, on each side of a panel boundary, last
DIAG_BAD = [(n, j) for n in DIAG_NS for j in sorted({0, 31, 32, n - 1}) if j < n]


def _spd_block(n, dtype, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return torch.from_numpy(g @ g.T / n + np.eye(n)).to(dtype).cuda()


def _within(got, want, n, dtype):
    """Within 100 n eps of the twin's largest entry of that output."""
    return float((got - want).abs().max()) <= 100 * n * _eps(dtype) * float(want.abs().max())


def _diag_entries(a, b):
    """chol_diag_inv on a; the lu_diag_inv and unit_linv entry points
    themselves on b (U^-1 and L^-1 unsmeared by a tile product)."""
    l, x = tk.chol_diag_inv(a)
    lu, ux, lx = torch.empty_like(b), torch.empty_like(b), torch.empty_like(b)
    tk._launch_lu("lu_diag_inv", "test", b, lu, ux)
    tk._launch_lu("unit_linv", "test", lu, lx)
    torch.cuda.synchronize()
    return l, x, lu, ux, lx


@pytest.mark.cuda
@pytest.mark.parametrize("n", DIAG_NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_diag_block_kernels_match_twins_over_n(card, n, dtype):
    a, b = _spd_block(n, dtype, n), _lu_block(n, dtype, n + 1)
    l, x, lu, ux, lx = _diag_entries(a, b)
    lp, xp = tk.chol_diag_inv_plain(a)
    lup, uxp = tk.lu_diag_inv_plain(b)
    lxp = tk.unit_linv_plain(lu)
    eye = torch.eye(n, dtype=dtype, device="cuda")
    lo = lu.tril(-1) + eye
    assert _within(l, lp, n, dtype) and _within(x, xp, n, dtype)
    assert _residual_ratio(l, l.T, a) <= 1 and _residual_ratio(l, x, eye) <= 1
    assert _within(lu.tril(-1), lup.tril(-1), n, dtype) and _within(lu.triu(), lup.triu(), n, dtype)
    assert _residual_ratio(lo, lu.triu(), b) <= 1
    assert _within(ux, uxp, n, dtype) and _residual_ratio(lu.triu(), ux, eye) <= 1
    assert _within(lx, lxp, n, dtype) and _residual_ratio(lo, lx, eye) <= 1
    zero = torch.zeros_like(a)
    assert torch.equal(l.triu(1), zero.triu(1)) and torch.equal(x.triu(1), zero.triu(1))
    assert torch.equal(ux.tril(-1), zero.tril(-1)) and torch.equal(lx.triu(1), zero.triu(1))


@pytest.mark.cuda
@pytest.mark.parametrize("n,j", DIAG_BAD)
@pytest.mark.parametrize("dtype", DTYPES)
def test_diag_block_nan_and_zero_pivot_patterns(card, n, j, dtype):
    # Cholesky: a[j, j] = -1 is the first bad pivot; L and L^-1 NaN exactly
    # where the twin's are, the first NaN diagonal at j.  LU: row j zero,
    # U(j, j) = 0: L\U finite, U^-1 finite exactly where the twin's is
    # (every row above the last zero pivot non-finite), unit-L^-1 finite.
    a, b = _spd_block(n, dtype, 3 * n + j), _lu_block(n, dtype, 5 * n + j)
    a[j, j] = -1.0
    b[j, :] = 0
    l, x, lu, ux, lx = _diag_entries(a, b)
    lp, xp = tk.chol_diag_inv_plain(a)
    lup, uxp = tk.lu_diag_inv_plain(b)
    assert torch.equal(torch.isnan(l), torch.isnan(lp)) and torch.equal(torch.isnan(x), torch.isnan(xp))
    assert int(torch.isnan(l.diagonal()).nonzero()[0]) == j
    zero = torch.zeros_like(a)
    assert torch.equal(l.triu(1), zero.triu(1)) and torch.equal(x.triu(1), zero.triu(1))
    assert bool(torch.isfinite(lu).all()) and float(lu[j, j]) == 0.0
    assert torch.equal(torch.isfinite(ux), torch.isfinite(uxp))
    assert torch.equal(ux.tril(-1), zero.tril(-1))
    assert _within(lu.triu(), lup.triu(), n, dtype)
    assert bool(torch.isfinite(lx).all()) and _within(lx, tk.unit_linv_plain(lu), n, dtype)


# ---------------------------------------------------------------------------
# the Householder panel kernels (csrc/qr_panel.cu)
# ---------------------------------------------------------------------------


def _panel(m, w, dtype, seed, zero_col=None):
    """A randn panel; column ``zero_col`` zero (a dead column at its step:
    every reflection keeps it exactly zero) and a -0.0 first pivot, whose
    sign must read +1 (beta = -anorm < 0; copysign would flip it)."""
    g = np.random.default_rng(seed).standard_normal((m, w))
    if zero_col is not None:
        g[:, zero_col] = 0
    g[0, 0] = -0.0
    return torch.from_numpy(g).to(dtype).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 256), (2000, 64), (40, 64), (3000, 100)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_panel_kernel_matches_twin(card, shape, dtype):
    m, w = shape
    a = _panel(m, w, dtype, seed=m + w, zero_col=min(w, m) // 2)
    before = tk.qr_panel.launches
    got = tk.qr_panel(a)
    torch.cuda.synchronize()
    assert tk.qr_panel.launches == before + 1
    want = tk.qr_panel_plain(a)
    res = qr_panel_check(a, got, want, offset=False)
    assert qr_panel_ok(res), res
    k = min(m, w) // 2  # the zero column: tau 0, R(k, k) = alpha = 0
    assert float(got[1][k]) == 0.0 and float(got[0][k, k]) == 0.0
    assert float(got[0][0, 0]) < 0 and float(want[0][0, 0]) < 0  # the -0.0 pivot
    if m < w:  # min(m, w) steps: the columns right of m keep the updated a
        assert torch.equal(got[1][m:], torch.zeros_like(got[1][m:]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_panel_offset_kernel_batched_with_row0(card, dtype):
    m, w = 1024, 256
    a = torch.stack([_panel(m, w, dtype, seed=s, zero_col=7) for s in (1, 2, 3)])
    row0 = [0, 256, m - w]
    rows = torch.arange(m, device="cuda")
    for i, r0 in enumerate(row0):
        a[i, rows < r0] = 0
        a[i, r0, 0] = -0.0  # the first pivot
    before = tk.qr_panel_offset.launches
    got = tk.qr_panel_offset(a, row0)
    torch.cuda.synchronize()
    assert tk.qr_panel_offset.launches == before + 1  # one launch for the batch
    want = tk.qr_panel_offset_plain(a, row0)
    for i, r0 in enumerate(row0):
        gi = tuple(x[i] for x in got)
        res = qr_panel_check(a[i], gi, tuple(x[i] for x in want), offset=True, row0=r0)
        assert qr_panel_ok(res), (r0, res)
        assert torch.equal(gi[0][:r0], torch.zeros_like(gi[0][:r0]))  # rows < row0 untouched
        assert torch.equal(gi[1][:r0], torch.zeros_like(gi[1][:r0]))
        assert float(gi[2][7]) == 0.0 and float(gi[1][r0 + 7, 7]) == 0.0  # dead: tau 0, pivot 0
        # the -0.0 pivot with weight below: sign +1 (beta < 0), as the twin
        assert float(gi[0][r0, 0]) < 0 and float(want[0][i, r0, 0]) < 0


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
def test_qr_checks_fail_a_wrong_factor(card, offset):
    """Each part zeroed (V below its pivots, R off its pivots, T's
    off-diagonal) fails its own reading; a doubled T column fails WY."""
    m, w, row0 = 16384, 64, 8192 if offset else 0
    a = _panel(m, w, torch.float32, seed=5)
    if offset:
        a[:row0] = 0
        got, want = tk.qr_panel_offset(a, row0), tk.qr_panel_offset_plain(a, row0)
    else:
        got, want = tk.qr_panel(a), tk.qr_panel_plain(a)
    assert qr_panel_ok(qr_panel_check(a, got, want, offset, row0))
    for reading, bad in qr_panel_mutants(got, offset, row0).items():
        assert qr_panel_check(a, bad, want, offset, row0)[reading] > 1, reading


def _edge_checks(a, got, want, offset, row0, variant):
    res, bad = qr_edge_checks(a, got, want, offset, row0, variant)
    assert not bad, (bad, res)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", QR_EDGE_VARIANTS)
@pytest.mark.parametrize("dtype,shape", [(dt, sh) for dt in DTYPES for sh in qr_edge_plain(dt)],
                         ids=lambda x: f"{x[0]}x{x[1]}" if isinstance(x, tuple) else str(x)[6:])
def test_qr_panel_kernel_edge_shapes(card, dtype, shape, variant):
    """Widths off and at the 32-column block, m < w, m ragged against the
    CTA rows, in f64 a panel whose CTA rows stay in global memory."""
    m, w = shape
    a = torch.from_numpy(qr_edge_panel(m, w, variant, m + w)).to(dtype).cuda()
    got = tk.qr_panel(a)
    torch.cuda.synchronize()
    _edge_checks(a, got, tk.qr_panel_plain(a), False, 0, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", QR_EDGE_VARIANTS)
@pytest.mark.parametrize("shape", QR_EDGE_OFFSET, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_panel_offset_kernel_edge_shapes(card, dtype, shape, variant):
    """row0 at 0, a middle row and m - w, three panels in one launch."""
    m, w = shape
    r0s = qr_edge_row0s(m, w)
    a = torch.stack([torch.from_numpy(qr_edge_panel(m, w, variant, m + i, r)) for i, r in enumerate(r0s)])
    a = a.to(dtype).cuda()
    got = tk.qr_panel_offset(a, r0s)
    torch.cuda.synchronize()
    want = tk.qr_panel_offset_plain(a, r0s)
    for i, r in enumerate(r0s):
        _edge_checks(a[i], tuple(x[i] for x in got), tuple(x[i] for x in want), True, r, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", QR_EDGE_VARIANTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_panel_offset_kernel_rows_in_global_memory(card, dtype, variant):
    """Eight panels in one launch, more rows a CTA than shared memory holds
    (the kernel's global-memory form, f32 included), row0 spread over
    0 .. m - w."""
    bsz, m, w = QR_EDGE_OFFSET_GLOBAL
    assert qr_rows_in_global(tk, dtype, bsz, m, w)
    r0s = qr_edge_row0s(m, w, bsz)
    a = torch.stack([torch.from_numpy(qr_edge_panel(m, w, variant, m + i, r)) for i, r in enumerate(r0s)])
    a = a.to(dtype).cuda()
    got = tk.qr_panel_offset(a, r0s)
    torch.cuda.synchronize()
    want = tk.qr_panel_offset_plain(a, r0s)
    for i, r in enumerate(r0s):
        _edge_checks(a[i], tuple(x[i] for x in got), tuple(x[i] for x in want), True, r, variant)


@pytest.mark.cuda
def test_qr_panel_nan_gives_the_twins_nan_tau(card):
    """A NaN below the first pivot reaches every CTA's sums: the kernel
    returns (no hang) with the twin's NaN tau."""
    for dtype in DTYPES:
        a = torch.from_numpy(qr_edge_panel(1000, 33, "neg0", 5)).to(dtype).cuda()
        a[700, 0] = float("nan")
        got, want = tk.qr_panel(a), tk.qr_panel_plain(a)
        torch.cuda.synchronize()
        assert bool(got[1][0].isnan()) and bool(want[1][0].isnan())


@pytest.mark.cuda
def test_qr_sync_probes_time_the_grid(card):
    """The floor helpers: one column exchange and one block barrier at the
    mesh panel's grid take microseconds, not zero and not milliseconds."""
    for dtype in DTYPES:
        for mode in ("exchange", "barrier"):
            ms = tk.qr_sync_ms(dtype, 2, 8192, 256, mode, iters=200)
            assert 1e-5 < ms < 0.1, (dtype, mode, ms)


@pytest.mark.cuda
def test_qr_wrappers_raise_instead_of_falling_back(card):
    with pytest.raises(TypeError, match="not supported on CUDA"):
        tk.qr_panel(torch.zeros((64, 8), dtype=torch.bfloat16, device="cuda"))
    with pytest.raises(ValueError, match="width"):
        tk.qr_panel(torch.zeros((600, 300), device="cuda"))
    with pytest.raises(ValueError, match="row0"):
        tk.qr_panel_offset(torch.zeros((64, 16), device="cuda"), 50)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_geqrf_and_gels_mesh_on_card_against_the_host(card, dtype):
    from slate_tpu_torch.linalg.qr import gels_array, geqrf_array
    from slate_tpu_torch.parallel import gels_mesh

    m, n, nb = 1000, 300, 64
    g = np.random.default_rng(31).standard_normal((m, n))
    b = np.random.default_rng(32).standard_normal((m, 4))
    a = torch.from_numpy(g).to(dtype)
    bt = torch.from_numpy(b).to(dtype)
    counts = (tk.qr_panel.launches, tk.qr_panel_offset.launches)
    res = {}
    for dev in ("cpu", "cuda"):
        res[dev] = gels_mesh(a.to(dev), bt.to(dev), make_mesh(2, 4, device=dev), nb)[0].cpu()
    nt = 8  # 300 / 64 -> 5 tiles, padded to lcm(2, 4)
    assert (tk.qr_panel.launches - counts[0], tk.qr_panel_offset.launches - counts[1]) == (nt, nt)
    eps = _eps(dtype)
    assert float((res["cuda"] - res["cpu"]).abs().max()) < 100 * m * eps * float(res["cpu"].abs().max())
    f = geqrf_array(a.cuda())
    x = gels_array(a.cuda(), bt.cuda()).double().cpu()
    a64 = a.double()
    # the normal equations' residual of tester.py's run_gels
    r = (a64.T @ (a64 @ x - bt.double())).abs().max() / (a64.abs().max() ** 2 * x.abs().max() * m)
    assert float(r) < 100 * n * eps
    assert gels_omega(a, x.to(dtype), bt) < gels_omega_gate(m, dtype)
    assert gels_omega(a, res["cuda"], bt) < gels_omega_gate(m, dtype)
    assert f.vr.shape == (m, n) and f.t.shape == (n, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_gels_launches_the_kernel(card, dtype):
    """A bf16/f16 gels factors its panels on the kernel in f32 (no plain
    pair on the card): one qr_panel launch per leaf, and gels_mesh one
    qr_panel_offset per step; X within 10 eps_half max|X| of the f32 solve
    of the same rounded operands."""
    from slate_tpu_torch.linalg.qr import gels_array
    from slate_tpu_torch.parallel import gels_mesh

    m, n, nb = 2048, 256, 64
    a = torch.from_numpy(np.random.default_rng(41).standard_normal((m, n))).to(dtype).cuda()
    b = torch.from_numpy(np.random.default_rng(42).standard_normal((m, 4))).to(dtype).cuda()
    x32 = gels_array(a.float(), b.float())
    heps = _eps(dtype)
    before = tk.qr_panel.launches
    x = gels_array(a, b)
    assert tk.qr_panel.launches - before == n // 64  # the leaves of _geqrf_rec
    assert x.dtype == dtype
    assert float((x.float() - x32).abs().max()) < 10 * heps * float(x32.abs().max())
    before = tk.qr_panel_offset.launches
    xm, info = gels_mesh(a, b, make_mesh(2, 4, device="cuda"), nb)
    assert tk.qr_panel_offset.launches - before == n // nb and int(info) == 0
    assert float((xm.float() - x32).abs().max()) < 10 * heps * float(x32.abs().max())


# ---------------------------------------------------------------------------
# the checksum-carrying SUMMA step (csrc/ft_summa_update.cu) and gemm_ft
# ---------------------------------------------------------------------------


def _ft_step(shape, dtype, seed, mt):
    """One ft_summa_update step's operands on a (2, 4) grid: acc (2, 4, I,
    J, nb, nb), stride-0 panels pan (2, 1, I) and urow (1, 4, J), and the
    weights of an augmented grid whose logical tile rows >= mt are checksum
    or pad rows (weight 0)."""
    I, J, nb = shape
    acc = _randn((2, 4, I, J, nb, nb), dtype, seed)
    pan = _randn((2, 1, I, nb, nb), dtype, seed + 1)
    urow = _randn((1, 4, J, nb, nb), dtype, seed + 2)
    part = _randn((2, 4, 2, J, nb, nb), dtype, seed + 3)
    _, _, i_log, _ = comm.local_indices(2, 4, I, J, "cuda")
    data = i_log < mt
    return acc, pan, urow, data.to(dtype), ((i_log + 1) * data).to(dtype), part


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mt", [((6, 3, 64), 10), ((1, 3, 256), 2), ((5, 1, 72), 8),
                                      ((34, 17, 256), 64)],
                         ids=["small", "I1", "ragged72", "path"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ft_summa_update_matches_twin(card, shape, mt, dtype):
    from slate_tpu_torch.utils.testing import ft_summa_check

    if shape[0] == 34 and dtype == torch.float64:
        shape = (18, 9, 256)  # the f64 path shape (n = 8192)
        mt = 32
    acc, pan, urow, w1, w2, part = _ft_step(shape, dtype, 7, mt)
    assert bool((w1 == 0).any()) or shape[0] * 2 <= mt  # checksum rows carry weight 0
    before = tk.ft_summa_update.launches
    got = tuple(x.clone() for x in tk.ft_summa_update(acc.clone(), pan, urow, w1, w2, part.clone()))
    torch.cuda.synchronize()
    assert tk.ft_summa_update.launches == before + 1
    want = tk.ft_summa_update_plain(acc.clone(), pan, urow, w1, w2, part.clone())
    readings = ft_summa_check(acc, pan, urow, w1, w2, part, got, want)
    assert all(v <= 1 for v in readings.values()), readings
    # a zeroed part fails its reading
    zero = (got[0], torch.zeros_like(got[1]))
    bad = ft_summa_check(acc, pan, urow, w1, w2, part, zero, want)
    assert bad["part0"] > 1 and bad["part1"] > 1


@pytest.mark.cuda
def test_ft_summa_update_raises_instead_of_falling_back(card):
    acc, pan, urow, w1, w2, part = _ft_step((2, 2, 16), torch.float32, 3, 3)
    with pytest.raises(TypeError, match="not supported on CUDA"):
        tk.ft_summa_update(acc.bfloat16(), pan.bfloat16(), urow.bfloat16(), w1.bfloat16(),
                           w2.bfloat16(), part.bfloat16())
    with pytest.raises(ValueError, match="one CUDA device"):
        tk.ft_summa_update(acc.cpu(), pan, urow, w1, w2, part)
    with pytest.raises(ValueError, match="one CUDA device"):
        tk.ft_summa_update(acc, pan.cpu(), urow, w1, w2, part)
    with pytest.raises(ValueError, match="square"):
        tk.ft_summa_update(acc[..., :8], pan, urow, w1, w2, part)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_gemm_ft_launches_the_kernel(card, dtype):
    """A bf16/f16 gemm_ft reaches the kernel in f32 (no plain product on the
    card): one ft_summa_update launch per k-step, the online discrepancy
    recorded, the result in the input dtype within 2 eps_half max|C| of the
    f32 product of the same rounded operands."""
    from slate_tpu_torch.ft import FtPolicy, abft
    from slate_tpu_torch.obs import REGISTRY

    n, nb = 1000, 64  # 16 k-steps
    a = torch.from_numpy(generate("randn", n, seed=23)).to(dtype).cuda()
    b = torch.from_numpy(generate("randn", n, seed=24)).to(dtype).cuda()
    REGISTRY.reset()
    before = tk.ft_summa_update.launches
    c, rep = abft.gemm_ft(1.0, a, b, make_mesh(2, 4, device="cuda"), nb, policy=FtPolicy.Detect)
    torch.cuda.synchronize()
    assert tk.ft_summa_update.launches - before == 16
    assert rep.clean and c.dtype == dtype
    assert REGISTRY.gauge_value("ft.online_disc", op="gemm") >= 0
    ref = a.float() @ b.float()
    assert float((c.float() - ref).abs().max()) <= 2 * _eps(dtype) * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_ft_on_card(card, dtype):
    """gemm_ft on the card: bitwise the same C at lookahead 0 and 2, one
    ft_summa_update launch per k-step, the online discrepancy far below the
    host threshold, and a trailing fault corrected to the clean result's
    tolerance."""
    from slate_tpu_torch.ft import FaultPlan, FtPolicy, abft, fault_scope, inject
    from slate_tpu_torch.ft.checksum import threshold
    from slate_tpu_torch.obs import REGISTRY

    n, nb = 1000, 64  # 16 tiles, padded from 15.6
    mesh = make_mesh(2, 4, device="cuda")
    a = torch.from_numpy(generate("randn", n, seed=21)).to(dtype).cuda()
    b = torch.from_numpy(generate("randn", n, seed=22)).to(dtype).cuda()
    outs = []
    for la in (0, 2):
        before = tk.ft_summa_update.launches
        c, rep = abft.gemm_ft(1.0, a, b, mesh, nb, policy=FtPolicy.Detect, lookahead=la)
        torch.cuda.synchronize()
        assert rep.clean and tk.ft_summa_update.launches - before == 16
        outs.append(c)
    assert torch.equal(outs[0], outs[1])
    kt = 16
    tol = threshold((kt + 18) * nb, dtype, 18 * float(outs[0].abs().max()))
    assert 0 <= REGISTRY.gauge_value("ft.online_disc", op="gemm") < 1e-2 * tol
    ref = a.double() @ b.double()
    gate = 4 * math.sqrt(n) * _eps(dtype) * float(ref.abs().max())
    assert float((outs[0].double() - ref).abs().max()) < gate
    f = inject.seeded_fault(21, "gemm", kt, (2, 4), phase="trailing")
    with fault_scope(FaultPlan([f])):
        c, rep = abft.gemm_ft(1.0, a, b, mesh, nb, policy=FtPolicy.Correct)
    assert rep.action == "corrected" and rep.detections
    assert float((c.double() - ref).abs().max()) < gate


# ---------------------------------------------------------------------------
# the tile kernels (csrc/tile_ops.cu)
# ---------------------------------------------------------------------------

TILE_DTYPES = [torch.float32, torch.bfloat16]
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _tile_stack(shape, dtype, seed):
    a = _randn(shape, torch.float32, seed).to(dtype)
    a[min(1, shape[0] - 1), 0, min(2, shape[2] - 1)] = float("nan")  # one NaN tile
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128, 256), (3, 100, 37), (70000, 2, 128)])
@pytest.mark.parametrize("dtype", TILE_DTYPES)
def test_tile_kernels_match_twins(card, shape, dtype):
    """transpose and genorm_max bitwise the twin, NaN included (compared as
    bits); geadd within eps (|alpha a| + |beta b|) of it (the kernel rounds
    the same exact sum once, as the twin); one launch each.  (70000, 2, 128)
    strides the stack index past the grid's 65535."""
    a, b = _tile_stack(shape, dtype, 1), _randn(shape, torch.float32, 2).to(dtype)
    before = [getattr(tk, w).launches for w in ("transpose_tiles", "geadd_tiles",
                                                 "genorm_max_tiles")]
    t = tk.transpose_tiles(a)
    n = tk.genorm_max_tiles(a)
    g = tk.geadd_tiles(0.3, a, -1.7, b)
    torch.cuda.synchronize()
    after = [getattr(tk, w).launches for w in ("transpose_tiles", "geadd_tiles",
                                                "genorm_max_tiles")]
    assert [x - y for x, y in zip(after, before)] == [1, 1, 1]
    bits = _BITS[dtype]
    assert t.shape == (shape[0], shape[2], shape[1])
    assert torch.equal(t.view(bits), tk.transpose_tiles_plain(a).view(bits))
    np_ = tk.genorm_max_tiles_plain(a)
    assert torch.equal(torch.isnan(n), torch.isnan(np_)) and bool(torch.isnan(n[1]))
    assert torch.equal(n.nan_to_num(), np_.nan_to_num())
    al, be = (float(torch.tensor(x, dtype=dtype)) for x in (0.3, -1.7))
    scale = (al * a.double()).abs() + (be * b.double()).abs()
    gp = tk.geadd_tiles_plain(0.3, a, -1.7, b)
    ok = torch.isfinite(scale)
    diff = (g.double() - gp.double()).abs()
    assert bool((diff[ok] <= torch.finfo(dtype).eps * scale[ok]).all())
    assert torch.equal(torch.isnan(g), torch.isnan(gp))


@pytest.mark.cuda
def test_tile_kernels_raise_instead_of_falling_back(card):
    a = _randn((8, 128, 128), torch.float32, 3)
    with pytest.raises(TypeError, match="not supported on CUDA"):
        tk.transpose_tiles(a.double())
    with pytest.raises(TypeError, match="not supported on CUDA"):
        tk.genorm_max_tiles(a.half())
    with pytest.raises(ValueError, match="contiguous"):
        tk.genorm_max_tiles(a.transpose(1, 2))
    with pytest.raises(ValueError, match="one shape"):
        tk.geadd_tiles(1.0, a, 1.0, a[:4])
    with pytest.raises(ValueError, match="unsupported device"):
        tk.geadd_tiles(1.0, a, 1.0, a.cpu())


@pytest.mark.cuda
def test_ops_transpose_takes_the_kernel_through_the_gate(card):
    from slate_tpu_torch.ops import transpose

    big = _randn((8, 128, 256), torch.float32, 4)
    before = tk.transpose_tiles.launches
    out = transpose(big)
    torch.cuda.synchronize()
    assert tk.transpose_tiles.launches - before == 1
    assert torch.equal(out, big.transpose(-1, -2))
    small = _randn((4, 128, 256), torch.float32, 5)  # k < 8: below the gate
    assert torch.equal(transpose(small), small.transpose(-1, -2))
    assert torch.equal(transpose(big.double()), big.double().transpose(-1, -2))
    assert tk.transpose_tiles.launches - before == 1
    # a strided stack goes to the kernel contiguous
    strided = _randn((8, 256, 128), torch.float32, 6).transpose(1, 2)
    assert torch.equal(transpose(strided), strided.transpose(-1, -2))
    assert tk.transpose_tiles.launches - before == 2


# ---------------------------------------------------------------------------
# the blocked GEMM (csrc/matmul.cu), the Ozaki planes and the mixed ladder
# ---------------------------------------------------------------------------


MATMUL_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", MATMUL_DTYPES)
@pytest.mark.parametrize("shape", [(1000, 777, 1234), (17, 3, 5), (300, 1, 129), (129, 2048, 257),
                                   (32768, 256, 32768)])
def test_matmul_pallas_kernel_matches_its_twin(card, dtype, shape):
    """The kernel against its twin within utils.testing.matmul_pallas_excess
    (9 sqrt(k) eps32 |A||B| elementwise, plus one output ulp for bf16/f16),
    one launch per call, any strides, and a second call bitwise the first
    (no atomics, one k order).  (32768, 256, 32768) is the factorizations'
    thin-k rank update."""
    from slate_tpu_torch.ops.matmul import matmul_pallas, pallas_blocks
    from slate_tpu_torch.utils.testing import matmul_pallas_excess

    m, k, n = shape
    a = _randn((m, k), torch.float32, 20).to(dtype)
    b = _randn((k, n), torch.float32, 21).to(dtype)
    before = tk.matmul_pallas.launches
    c = matmul_pallas(a, b)
    torch.cuda.synchronize()
    assert tk.matmul_pallas.launches - before == 1
    assert c.shape == (m, n) and c.dtype == dtype
    assert torch.equal(matmul_pallas(a, b), c)
    want = tk.matmul_pallas_plain(a, b, *pallas_blocks(m, k, n))
    assert matmul_pallas_excess(a, b, c, want) <= 1.0
    ct = matmul_pallas(a.T.contiguous().T, b.T.contiguous().T)  # column-major operands
    assert matmul_pallas_excess(a, b, ct, want) <= 1.0


def _matmul_views(dtype, seed):
    """(name, a, b, a's path, b's path) operand views, a path being "k" (in
    place, k contiguous), "mn" (in place, a row-major B) or "pack": each
    16-bit operand goes to the core in place exactly where TMA can read it."""
    big_a = _randn((401, 530), torch.float32, seed).to(dtype)
    big_b = _randn((530, 1300), torch.float32, seed + 1).to(dtype)
    wide_b = _randn((520, 1304), torch.float32, seed + 3).to(dtype)  # rows of 1304 elements
    bt = _randn((1234, 512), torch.float32, seed + 2).to(dtype)
    return [
        ("row_major", big_a[:, :512].contiguous(), big_b[:512, :1234].contiguous(), "k", "pack"),
        ("row_major_b", big_a[:, :512].contiguous(), big_b[:512, :1000].contiguous(), "k", "mn"),
        ("col_major", big_a[:, :512].T.contiguous().T, bt.T, "pack", "k"),
        ("offset", big_a[1:, 3:], big_b[3:, 5:], "pack", "pack"),  # bases off 16 bytes
        ("offset_b", big_a[:, 8:520], wide_b[2:514, 8:1008], "pack", "mn"),  # a row stride of 530
        ("odd_n", big_a[:, :512].contiguous(), big_b[:512, :777].contiguous(), "k", "pack"),
        ("strided", big_a[::2, ::3], big_b[::3, ::2], "pack", "pack"),
        ("b_transposed", big_a[:, 8:520], bt.T, "pack", "k"),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", MATMUL_DTYPES)
def test_matmul_pallas_any_layout(card, dtype):
    """Offset views, odd strides, an odd n, a transposed B, a row-major B
    read MN-major: each operand takes the path matmul_operand_plan gives it,
    and C holds to the twin."""
    from slate_tpu_torch.ops.matmul import matmul_pallas, pallas_blocks
    from slate_tpu_torch.utils.testing import matmul_pallas_excess

    paths = {"k": (True, True), "mn": (True, False), "pack": (False, True)}
    for name, a, b, a_path, b_path in _matmul_views(dtype, 30):
        if dtype == torch.float32:
            a_path = b_path = "pack"
        plan_a, plan_b = tk._matmul_plan(a, "a"), tk._matmul_plan(b, "b")
        assert (plan_a.in_place, plan_a.k_major) == paths[a_path], name
        assert (plan_b.in_place, plan_b.k_major) == paths[b_path], name
        packs = tk.matmul_pack.launches
        c = matmul_pallas(a, b)
        torch.cuda.synchronize()
        assert tk.matmul_pack.launches - packs == (a_path == "pack") + (b_path == "pack"), name
        want = tk.matmul_pallas_plain(a, b, *pallas_blocks(a.shape[0], a.shape[1], b.shape[1]))
        assert matmul_pallas_excess(a, b, c, want) <= 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", MATMUL_DTYPES)
def test_matmul_pack_matches_its_model(card, dtype):
    """The pack kernel's K-major planes, bitwise: utils.testing.bf16_planes
    of the operand for f32 (NaN, +-inf, zeros and huge values included), the
    operand itself for bf16 / f16."""
    from slate_tpu_torch.utils.testing import bf16_planes

    for name, a, b, _, _ in _matmul_views(dtype, 40):
        if dtype == torch.float32:
            a = a.clone()
            a[0, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0])
            a[1, :3] = torch.tensor([3.4e38, -3.4e38, 2.0 ** -120])
        for t, which in ((a, "a"), (b, "b")):
            planes = tk.matmul_pack(t, which)
            kmajor = t if which == "a" else t.T
            k = kmajor.shape[1]
            got = planes[:, :, :k]
            if dtype == torch.float32:
                want = bf16_planes(kmajor)
                assert got.shape == want.shape
                same = (got.float() == want) | (got.float().isnan() & want.isnan())
                assert bool(same.all()), (name, which)
            else:
                assert got.shape == (1, *kmajor.shape)
                assert torch.equal(got[0], kmajor), (name, which)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", MATMUL_DTYPES)
def test_matmul_pallas_nan_and_inf(card, dtype):
    """NaN propagates exactly where the twin's does.  bf16/f16: the +-inf
    pattern is the twin's too.  f32: an inf goes whole into plane 0 with zero
    planes below, so where the other operand's value is exact in bf16 (zero
    lower planes) 0 * inf reads NaN where the twin reads +-inf: the kernel's
    non-finite pattern is the six-product model's (utils.testing.
    matmul_split6_model), signs included."""
    from slate_tpu_torch.utils.testing import matmul_split6_model

    a = _randn((200, 300), torch.float32, 50).to(dtype)
    b = _randn((300, 150), torch.float32, 51).to(dtype)
    a[3, 7] = float("nan")
    a[5, 11] = float("inf")
    a[9, 13] = -float("inf")
    b[20, 40] = float("inf")
    b[:, 60] = b[:, 60].to(torch.bfloat16).to(dtype)  # exact in bf16: zero lower planes
    b[11, 70] = 1.0
    c = tk.matmul_pallas(a, b)
    want = tk.matmul_pallas_plain(a, b)
    assert torch.equal(c.isnan() & want.isnan(), want.isnan())  # NaN wherever the twin's is
    if dtype == torch.float32:
        model = matmul_split6_model(a, b)
        assert torch.equal(c.isnan(), model.isnan())
        assert torch.equal(c.isinf(), model.isinf())
        assert torch.equal(c[c.isinf()], model[model.isinf()])
        assert bool(c[5, 60].isnan()) and bool(want[5, 60].isinf())  # 0 * inf: NaN, the twin inf
    else:
        assert torch.equal(c.isnan(), want.isnan())
        assert torch.equal(c.isinf(), want.isinf())
        assert torch.equal(c[c.isinf()], want[want.isinf()])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(17, 3, 5), (300, 256, 400), (129, 2048, 257), (1000, 777, 1234),
                                   (64, 8192, 96)])
def test_matmul_pallas_f32_matches_split6_model(card, shape):
    """The f32 form against the six plane products it sums
    (utils.testing.matmul_split6_reading), at both stage depths (k <= 256
    and above): within MATMUL_SPLIT6_LIMIT, while the kernel's C with any
    one second-order plane pair dropped, and a TF32-like product (operands
    cut to TF32's 10 mantissa bits), read above it.  The twin tolerance
    passes both of those."""
    from slate_tpu_torch.utils.testing import MATMUL_SPLIT6_LIMIT, matmul_split6_reading

    m, k, n = shape
    a = _randn((m, k), torch.float32, 70)
    b = _randn((k, n), torch.float32, 71)
    c = tk.matmul_pallas(a, b)
    reading, faults = matmul_split6_reading(a, b, c)
    cut = torch.tensor(-8192, dtype=torch.int32, device="cuda")  # 0xffffe000: 10 mantissa bits
    tf32 = (a.view(torch.int32) & cut).view(torch.float32) @ (b.view(torch.int32) & cut).view(torch.float32)
    tf32_reading = matmul_split6_reading(a, b, tf32)[0]
    print(f"split6 {shape}: kernel {reading:.4f}, dropped pair {faults}, tf32 {tf32_reading:.1f}")
    assert reading <= MATMUL_SPLIT6_LIMIT
    assert min(faults.values()) > MATMUL_SPLIT6_LIMIT
    assert tf32_reading > MATMUL_SPLIT6_LIMIT


@pytest.mark.cuda
def test_matmul_pallas_tiny_f32(card):
    """f32 values near 2^-115, below the range (|x| >= 2^-110) where the
    three bf16 planes hold every bit: the lowest plane is a bf16 subnormal
    (under 2^-126).  The tensor cores keep bf16 subnormals: the kernel's
    error from the exact product is the split's own, as the model's (which
    keeps them) is, ~2^-21 of max |A||B| (H100: 5.66e-7 against the
    model's 5.56e-7); flushing the lowest plane would read ~2^-16."""
    from slate_tpu_torch.utils.testing import matmul_split6_model

    a = _randn((256, 512), torch.float32, 60) * 2.0 ** -115
    b = _randn((512, 256), torch.float32, 61)
    c = tk.matmul_pallas(a, b).double()
    exact = a.double() @ b.double()
    scale = float((a.double().abs() @ b.double().abs()).max())
    model = matmul_split6_model(a, b).double()
    err, model_err = float((c - exact).abs().max()) / scale, float((model - exact).abs().max()) / scale
    print(f"tiny f32: kernel {err:.3e}, model {model_err:.3e} of max|A||B|")
    assert err <= 2.0 ** -20


@pytest.mark.cuda
def test_matmul_pallas_raises_on_the_card(card):
    from slate_tpu_torch.ops.matmul import matmul_pallas

    a = torch.zeros((8, 8), dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        matmul_pallas(a, a)
    with pytest.raises(ValueError):
        tk.matmul_pallas(torch.zeros((8, 8), device="cuda"), torch.zeros((8, 8)), 128, 128, 128)


@pytest.mark.cuda
def test_matmul_pallas_counts_only_what_it_launches(card):
    """An empty C launches nothing and counts nothing; k = 0 launches the
    kernel, which writes zeros."""
    before = tk.matmul_pallas.launches
    for m, k, n in ((0, 5, 7), (6, 3, 0)):
        c = tk.matmul_pallas(torch.ones((m, k), device="cuda"), torch.ones((k, n), device="cuda"))
        assert c.shape == (m, n)
    assert tk.matmul_pallas.launches == before
    c = tk.matmul_pallas(torch.ones((4, 0), device="cuda"), torch.ones((0, 6), device="cuda"))
    torch.cuda.synchronize()
    assert tk.matmul_pallas.launches == before + 1 and bool((c == 0).all())


@pytest.mark.cuda
def test_ozaki_on_the_card_is_bitwise_the_cpu(card):
    from slate_tpu_torch.ops import ozaki
    from slate_tpu_torch.parallel.summa import gemm_summa_ozaki

    g = torch.Generator().manual_seed(3)
    a = torch.randn((300, 520), dtype=torch.float64, generator=g)
    b = torch.randn((520, 130), dtype=torch.float64, generator=g)
    a[3] = 0
    a[7, :4] = 1e-40
    for s in (9, 6):
        assert torch.equal(ozaki.matmul_f64(a.cuda(), b.cuda(), s).cpu(), ozaki.matmul_f64(a, b, s))
    ac, bc = torch.complex(a, a.flip(0)), torch.complex(b, -b)
    assert torch.equal(ozaki.matmul_c128(ac.cuda(), bc.cuda()).cpu(), ozaki.matmul_c128(ac, bc))
    n = 256
    sq = torch.randn((n, n), dtype=torch.float64, generator=g) + n * torch.eye(n, dtype=torch.float64)
    x = torch.randn((n, 3), dtype=torch.float64, generator=g)
    out = []
    for dev in ("cpu", "cuda"):
        mesh = make_mesh(2, 4, device=dev)
        out.append(to_dense(gemm_summa_ozaki(-1.0, from_dense(sq.to(dev), mesh, 32, diag_pad_one=True),
                                             from_dense(x.to(dev), mesh, 32), 1.0,
                                             from_dense(x.to(dev), mesh, 32))).cpu())
    assert torch.equal(out[0], out[1])


@pytest.mark.cuda
def test_mixed_ladder_on_the_card(card):
    """f64 posv_mesh / gesv_mesh under auto on the card: the refinement gate,
    the f32 factor's kernels and the f64 residual's summa_update launched;
    off launches what the direct path launches."""
    from slate_tpu_torch.parallel import gesv_mesh, posv_mesh
    from slate_tpu_torch.parallel.drivers import _posv_mesh_plain
    from slate_tpu_torch.types import Option
    from slate_tpu_torch.utils.testing import refine_gate_ok

    n, nb = 512, 64
    g = torch.Generator(device="cuda").manual_seed(9)
    a = torch.randn((n, n), dtype=torch.float64, device="cuda", generator=g)
    spd = a @ a.T / n + 2 * torch.eye(n, dtype=torch.float64, device="cuda")
    b = torch.randn((n, 4), dtype=torch.float64, device="cuda", generator=g)
    mesh = make_mesh(2, 4, device="cuda")
    names = ("chol_panel_tiles", "chol_trailing_update", "summa_update", "lu_rowsolve_tiles")

    def counts():
        return {k: getattr(tk, k).launches for k in names}

    c0 = counts()
    x, info = posv_mesh(spd, b, mesh, nb)
    c1 = counts()
    assert int(info) == 0 and refine_gate_ok(spd, x, b)
    assert all(c1[k] > c0[k] for k in names[:3])
    x, info = gesv_mesh(a + n * torch.eye(n, dtype=torch.float64, device="cuda"), b, mesh, nb)
    assert int(info) == 0 and counts()["lu_rowsolve_tiles"] > c1["lu_rowsolve_tiles"]
    off = {Option.MixedPrecision: "off"}
    c2 = counts()
    x_off, _ = posv_mesh(spd, b, mesh, nb, opts=off)
    c3 = counts()
    x_pl, _ = _posv_mesh_plain(spd, b, mesh, nb, opts=off)
    c4 = counts()
    assert {k: c3[k] - c2[k] for k in names} == {k: c4[k] - c3[k] for k in names}
    assert torch.equal(x_off, x_pl)


# ---------------------------------------------------------------------------
# the tile-GEMM core (csrc/tile_mma.cuh) of tile_gemm.cu and
# ft_summa_update.cu, over nb, in both load forms: views at offset 0 take the
# 16-byte copies where nb is a multiple of the vector, views one element off
# the element copies (the wrappers' load16 predicate)
# ---------------------------------------------------------------------------

TILE_NBS = [1, 7, 8, 31, 33, 100, 127, 128, 129, 200, 256]


def _at(shape, dtype, seed, off, scale=1.0):
    """randn of ``shape`` in a fresh buffer, ``off`` elements into it."""
    buf = torch.empty(math.prod(shape) + off, dtype=dtype, device="cuda")
    v = buf[off:].view(shape)
    v.copy_(_randn(shape, dtype, seed, scale))
    return v


def _finite_max(x):
    return float(x.abs().nan_to_num(0.0, 0.0, 0.0).max())


@pytest.mark.cuda
@pytest.mark.parametrize("off", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("nb", TILE_NBS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_gemm_modes_match_twins_over_nb(card, dtype, nb, off):
    """summa_update (+=), chol_trailing_update (-=, B^T, mask) and
    lu_trailing_update (-=, mask) against their twins within the tile-update
    tolerance; masked tiles holding NaN come back bitwise, and a NaN in a
    panel reaches exactly the outputs it reaches in the twin.  Then mode
    set with a shared operand through stride 0 (the three panel solves'
    launch forms: A_i X^T, A_i X, X A_j)."""
    c = _at((2, 4, 2, 3, nb, nb), dtype, nb, off)
    pan = _at((2, 1, 2, nb, nb), dtype, nb + 1, off, 0.5)
    rhs = _at((1, 4, 3, nb, nb), dtype, nb + 2, off, 0.5)
    vec = 16 // c.element_size()
    assert bool(tk._load16(pan, nb)) == bool(tk._load16(rhs, nb)) == (off == 0 and nb % vec == 0)
    pan[0, 0, 0, min(3, nb - 1), 0] = float("nan")
    mask = torch.rand((2, 4, 2, 3), generator=torch.Generator(device="cuda").manual_seed(nb),
                      device="cuda") < 0.6
    c[~mask] = float("nan")
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    for name, run, plain in (
            ("summa_update", lambda v: tk.summa_update(v, pan, rhs),
             lambda v: tk.summa_update_plain(v, pan, rhs)),
            ("chol_trailing_update", lambda v: tk.chol_trailing_update(v, pan, rhs, mask),
             lambda v: tk.chol_trailing_update_plain(v, pan, rhs, mask)),
            ("lu_trailing_update", lambda v: tk.lu_trailing_update(v, pan, rhs, mask),
             lambda v: tk.lu_trailing_update_plain(v, pan, rhs, mask))):
        got = c.clone()
        run(got)
        torch.cuda.synchronize()
        want = plain(c.clone())
        assert torch.equal(got.isnan(), want.isnan()), name
        fin = want.isfinite()
        tol = (8 * math.sqrt(nb) * _eps(dtype) * _finite_max(pan) * float(rhs.abs().max())
               + 2 * _eps(dtype) * max(_finite_max(c), _finite_max(want)))
        assert float((got[fin] - want[fin]).abs().max()) <= tol, name
        if name != "summa_update":
            assert torch.equal(got[~mask].view(bits), c[~mask].view(bits)), name
    tiles = _at((2, 1, 3, nb, nb), dtype, nb + 3, off)
    x = _at((nb, nb), dtype, nb + 4, off)
    for trans, shape, a, b, want in (
            (True, (2, 1, 3, 1, nb, nb), tiles, x[None, None, None], tiles @ x.T),
            (False, (2, 1, 3, 1, nb, nb), tiles, x[None, None, None], tiles @ x),
            (False, (2, 1, 1, 3, nb, nb), x[None, None, None], tiles, x @ tiles)):
        out = torch.full(shape, float("nan"), dtype=dtype, device="cuda")
        tk._tile_gemm(out, a, b, None, trans_b=trans, mode=tk._MODE_SET, who="set")
        torch.cuda.synchronize()
        got = out[:, :, :, 0] if shape[2] == 3 else out[:, :, 0]
        tol = (8 * math.sqrt(nb) * _eps(dtype) * float(tiles.abs().max()) * float(x.abs().max())
               + 2 * _eps(dtype) * float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("off", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("nb", TILE_NBS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ft_summa_update_over_nb_is_deterministic(card, dtype, nb, off):
    """ft_summa_update against its twin (ft_summa_check), and two launches
    bitwise equal: the in-order loop over i and the fixed k order leave no
    room for a run-to-run difference."""
    from slate_tpu_torch.utils.testing import ft_summa_check

    acc = _at((2, 4, 3, 2, nb, nb), dtype, nb, off, 10.0)
    pan = _at((2, 1, 3, nb, nb), dtype, nb + 1, off)
    urow = _at((1, 4, 2, nb, nb), dtype, nb + 2, off)
    part = _at((2, 4, 2, 2, nb, nb), dtype, nb + 3, off, 100.0)
    w1 = torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device="cuda").view(1, 1, 3)
    w2 = w1 * torch.arange(1, 4, dtype=dtype, device="cuda")
    one = tk.ft_summa_update(acc.clone(), pan, urow, w1, w2, part.clone())
    two = tk.ft_summa_update(acc.clone(), pan, urow, w1, w2, part.clone())
    torch.cuda.synchronize()
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    want = tk.ft_summa_update_plain(acc.clone(), pan, urow, w1, w2, part.clone())
    readings = ft_summa_check(acc, pan, urow, w1, w2, part, one, want)
    assert all(v <= 1 for v in readings.values()), readings
