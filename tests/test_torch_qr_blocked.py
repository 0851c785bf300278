"""The blocked Householder panel of csrc/qr_panel.cu, modelled in PyTorch on
the CPU and held against ``slate_tpu``'s Householder loops.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it against the plain twins there).  This file rehearses
its algorithm here, in the kernel's order: the rows cut into the launch's
CTAs (the rows-per-CTA rule and the block width read from the source), the
column loop blocked by kIb, each column step one exchange of per-CTA
partials summed over the CTAs in order (the norm below the pivot fused with
the dots against the block's other columns:
v^T a_k = (x^T a_k) / denom + u a_{g,k}), the look-ahead partials of the
next column formed from the updated rows, the block's T_b from its Gram
columns, the trailing columns updated once a block by the compact-WY block
reflector A_t -= V_b (T_b^T (V_b^T A_t)), and T's off-diagonal blocks
T[:j0, b] = -T[:j0, :j0] (V_{<b}^T V_b) T_b from the same products.

It is held to ``slate_tpu``'s ``_panel_qr`` + ``_larft`` and
``_panel_qr_offset`` + ``_larft_v`` (jitted, on the CPU) through
``utils.testing.qr_panel_check`` (each part within QR_PART_C m eps of its
own scale, Q R = A and the WY identity within m eps) at the edge shapes the
card tests use (``utils.testing.qr_edge_plain`` / ``QR_EDGE_OFFSET``: widths
1, 7, 33, 64, 100, 256; m < w; m ragged against the CTA rows; in f64 more
rows a CTA than shared memory holds; row0 at 0, a middle row and m - w), each with a -0.0 pivot and a dead column, and with
columns zero below their pivots; and ``qr_panel_mutants`` must fail on the
model's output.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import qr as jqr
from slate_tpu_torch.ops import _build
from slate_tpu_torch.utils import testing

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float64]
SMS = 132  # the H100's SMs: the launch's grid on the card


def _source():
    with open(os.path.join(_build.CSRC_DIR, "qr_panel.cu")) as f:
        return f.read()


def _const(name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, _source()).group(1))


def _header(dtype=torch.float32):
    """(kIb, CTAs per panel at most, rows per CTA at least) of the kernel."""
    src = _source()
    warps = _const("kThreads") // 32
    name = "kMaxNcF32" if dtype == torch.float32 else "kMaxNcF64"
    max_nc = int(re.search(r"constexpr int %s = (\d+) \* kWarps;" % name, src).group(1)) * warps
    return _const("kIb"), max_nc, _const("kMinRows")


def grid(batch, m, dtype=torch.float32):
    """The plan's CTAs per panel and rows per CTA (``grid_nc``)."""
    _, max_nc, min_rows = _header(dtype)
    nc = max(1, min(SMS // batch, -(-m // min_rows), max_nc))
    return nc, -(-m // nc)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def scalars(alpha, xn2, offset):
    """One column's reflector, as the kernel's warp 0 forms it:
    (tau, denom, u, R's diagonal entry).  sign +1 for alpha >= 0 (so -0.0
    gives +1 and NaN -1); a dead column (anorm == 0) has tau 0, and its
    pivot entry u is 1 in the plain form and 0 in the offset form."""
    anorm = torch.sqrt(alpha * alpha + xn2)
    s = torch.where(alpha >= 0, torch.ones_like(alpha), -torch.ones_like(alpha))
    dead = anorm == 0
    beta = torch.where(dead, torch.ones_like(alpha), -s * anorm)
    tau = torch.where(dead, torch.zeros_like(alpha), (beta - alpha) / beta)
    denom = alpha - beta
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    u = torch.zeros_like(alpha) if (offset and bool(dead)) else torch.ones_like(alpha)
    return tau, denom, u, torch.where(dead, alpha, beta)


def cta_sums(parts):
    """The sum over the CTAs of their (nc, k) partials as every CTA forms
    it: warp gg adds the CTAs cc = gg (mod 16) in order, then the warps in
    order."""
    nc = parts.shape[0]
    per_warp = [parts[gg:nc:16].sum(0) if gg < nc else torch.zeros_like(parts[0]) for gg in range(16)]
    out = torch.zeros_like(parts[0])
    for x in per_warp:
        out = out + x
    return out


def model_panel(a, row0, offset, nc):
    """The kernel's blocked algorithm on one (m, w) panel cut into nc CTAs:
    (packed VR, tau, T), or the offset form's (r, v, tau, T)."""
    ib = _header()[0]
    m, w = a.shape
    dt = a.dtype
    steps = w if offset else min(m, w)
    rpc = -(-m // nc)
    rows = torch.arange(m)
    wk = a.clone()
    vout = torch.zeros_like(a) if offset else wk
    t = torch.zeros((w, w), dtype=dt)
    tau = torch.zeros(w, dtype=dt)

    def by_cta(x):
        """(nc, rpc, ...) view of a row-indexed tensor, zero past m."""
        pad = torch.zeros((nc * rpc - m,) + tuple(x.shape[1:]), dtype=dt)
        return torch.cat([x, pad]).view((nc, rpc) + tuple(x.shape[1:]))

    def partials(s, jj, g):
        """(nc, ib) per-CTA partials of column jj: sum over the CTA's rows
        below g of s[i, jj] s[i, :]."""
        mask = (rows > g).to(dt)[:, None]
        return by_cta(s[:, jj:jj + 1] * s * mask).sum(1)

    for j0 in range(0, steps, ib):
        ibe = min(ib, steps - j0)
        jend = j0 + ibe
        s = wk[:, j0:jend].clone()
        gram = torch.zeros((ibe, ibe), dtype=dt)
        tb = torch.zeros((ibe, ibe), dtype=dt)
        us = torch.zeros(ibe, dtype=dt)
        parts, piv = partials(s, 0, row0 + j0), s[row0 + j0].clone()
        for jj in range(ibe):
            g = row0 + j0 + jj
            d = cta_sums(parts)
            tj, denom, u, rd = scalars(piv[jj], d[jj], offset)
            z = d / denom + u * piv  # k > jj: v^T a_k; k < jj: v_k^T v_j
            gram[:jj, jj] = z[:jj]
            below = s[g + 1:, jj] * (1 / denom)  # v below the pivot
            v = torch.cat([u.reshape(1), below])
            s[g:, jj + 1:] -= (tj * v)[:, None] * z[None, jj + 1:]
            s[g + 1:, jj] = below
            s[g, jj] = rd
            tau[j0 + jj] = tj
            us[jj] = u
            # T_b's column jj from the Gram column (T_b[i, l] = 0 for l < i)
            tb[:jj, jj] = -tj * (tb[:jj, :jj] @ gram[:jj, jj])
            tb[jj, jj] = tj
            if jj + 1 < ibe:  # the look-ahead: column jj + 1's partials
                parts, piv = partials(s, jj + 1, g + 1), s[g + 1].clone()
        # block end: out to the panel, V_b with its pivot entries
        gk = row0 + j0 + torch.arange(ibe)
        vb = torch.where(rows[:, None] > gk[None, :], s,
                         torch.where(rows[:, None] == gk[None, :], us[None, :], torch.zeros((), dtype=dt)))
        if offset:
            wk[:, j0:jend] = torch.where(rows[:, None] > gk[None, :], torch.zeros((), dtype=dt), s)
            vout[:, j0:jend] = vb
        else:
            wk[:, j0:jend] = s
        other = [c for c in range(w) if c < j0 or c >= jend]
        if other:
            x = torch.stack([vout[:, c] if c < j0 else wk[:, c] for c in other], 1)
            p = cta_sums(by_cta(vb).transpose(1, 2) @ by_cta(x))
            y = tb.T @ p  # (ibe, other)
            ycol = dict(zip(other, y.T))
            if j0:
                yl = torch.stack([ycol[c] for c in range(j0)], 1)  # (ibe, j0)
                t[:j0, j0:jend] = -(t[:j0, :j0] @ yl.T)  # T[i, l] = 0 for l < i
            if jend < w:
                yt = torch.stack([ycol[c] for c in range(jend, w)], 1)
                wk[:, jend:] -= vb @ yt
        t[j0:jend, j0:jend] = tb
    if offset:
        return wk, vout, tau, t
    return wk, tau, t


# ---------------------------------------------------------------------------
# the reference: slate_tpu's Householder loops, jitted once per shape
# ---------------------------------------------------------------------------

_REF = {}


def reference(a, row0, offset):
    key = (tuple(a.shape), str(a.dtype), offset)
    fn = _REF.get(key)
    if fn is None:
        if offset:
            def f(x, r0):
                r, v, tau = jqr._panel_qr_offset(x, r0)
                return r, v, tau, jqr._larft_v(v, tau)
        else:
            def f(x, r0):
                vr, tau = jqr._panel_qr(x)
                return vr, tau, jqr._larft(vr, tau)
        fn = _REF[key] = jax.jit(f)
    out = fn(jnp.asarray(a.numpy()), row0)
    return tuple(torch.from_numpy(np.array(x)) for x in out)


def _check(a, got, want, offset, row0, variant):
    res, bad = testing.qr_edge_checks(a, got, want, offset, row0, variant)
    assert not bad, (bad, res)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_block_constants_are_the_headers():
    # 32-column blocks (a lane a column), one CTA an SM, at least 32 rows a
    # CTA, at most 128 CTAs a panel in f32 (one round of the exchange's
    # loads) and 64 in f64 (two tagged words a value)
    assert _header(torch.float32) == (32, 128, 32)
    assert _header(torch.float64) == (32, 64, 32)
    # the path's grids: the leaves 128 x 256 rows (f32) and 64 x 256 (f64),
    # the mesh panels 66 x 249 (f32) and 64 x 128 (f64), the CAQR merge
    # 16 x 32; the tall f64 edge panel 64 x 1094 (its rows in global memory)
    f64 = torch.float64
    assert grid(1, 32768) == (128, 256) and grid(1, 16384, f64) == (64, 256)
    assert grid(2, 16384) == (66, 249) and grid(2, 8192, f64) == (64, 128)
    assert grid(1, 512) == grid(1, 512, f64) == (16, 32)
    assert grid(1, 70000, f64) == (64, 1094)


def test_sign_rule():
    # -0.0 reads +1 (beta = -anorm), NaN reads -1; a dead column keeps
    # alpha on R's diagonal with tau 0 and a pivot entry 1 (plain) / 0 (offset)
    for dt in DTYPES:
        one = torch.ones((), dtype=dt)
        tau, _, _, rd = scalars(torch.tensor(-0.0, dtype=dt), 4 * one, False)
        assert float(rd) == -2.0 and float(tau) == 1.0
        tau, _, _, rd = scalars(torch.tensor(float("nan"), dtype=dt), one, False)
        assert math.isnan(float(rd)) and math.isnan(float(tau))
        for offset, unit in ((False, 1.0), (True, 0.0)):
            tau, denom, u, rd = scalars(torch.tensor(-0.0, dtype=dt), 0 * one, offset)
            assert float(tau) == 0.0 and float(u) == unit and float(rd) == 0.0 and float(denom) == -1.0


PLAIN_CASES = [(dt, shape) for dt in DTYPES for shape in testing.qr_edge_plain(dt)]


@pytest.mark.parametrize("variant", testing.QR_EDGE_VARIANTS)
@pytest.mark.parametrize("dtype,shape", PLAIN_CASES,
                         ids=[f"{str(dt)[-7:]}-{m}x{w}" for dt, (m, w) in PLAIN_CASES])
def test_plain_panel_model_matches_slate_tpu(dtype, shape, variant):
    m, w = shape
    a = torch.from_numpy(testing.qr_edge_panel(m, w, variant, m + w)).to(dtype)
    got = model_panel(a, 0, False, grid(1, m, dtype)[0])
    _check(a, got, reference(a, 0, False), False, 0, variant)


@pytest.mark.parametrize("variant", testing.QR_EDGE_VARIANTS)
@pytest.mark.parametrize("shape", testing.QR_EDGE_OFFSET, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_offset_panel_model_matches_slate_tpu(dtype, shape, variant):
    # one launch takes the three panels: the grid is the batch's
    m, w = shape
    r0s = testing.qr_edge_row0s(m, w)
    nc = grid(len(r0s), m, dtype)[0]
    for i, r0 in enumerate(r0s):
        a = torch.from_numpy(testing.qr_edge_panel(m, w, variant, m + i, r0)).to(dtype)
        got = model_panel(a, r0, True, nc)
        _check(a, got, reference(a, r0, True), True, r0, variant)


@pytest.mark.parametrize("variant", testing.QR_EDGE_VARIANTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_offset_panel_model_batch_of_eight(dtype, variant):
    # QR_EDGE_OFFSET_GLOBAL: eight panels in one launch, 16 CTAs of 1250
    # rows each (on the card those rows stay in global memory, f32 too)
    bsz, m, w = testing.QR_EDGE_OFFSET_GLOBAL
    nc, rpc = grid(bsz, m, dtype)
    assert (nc, rpc) == (16, 1250)
    for i, r0 in enumerate(testing.qr_edge_row0s(m, w, bsz)):
        a = torch.from_numpy(testing.qr_edge_panel(m, w, variant, m + i, r0)).to(dtype)
        got = model_panel(a, r0, True, nc)
        _check(a, got, reference(a, r0, True), True, r0, variant)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_merge_model_on_the_mesh_grid(dtype):
    # the CAQR merge (2nb, nb) of two upper-triangular R blocks at nb = 64,
    # cut into its launch's CTAs (columns zero below their pivots but for
    # the lower block's triangle)
    nb = 64
    g = np.random.default_rng(5)
    a = torch.from_numpy(np.concatenate([np.triu(g.standard_normal((nb, nb))),
                                         np.triu(g.standard_normal((nb, nb)))])).to(dtype)
    got = model_panel(a, 0, False, grid(1, 2 * nb, dtype)[0])
    _check(a, got, reference(a, 0, False), False, 0, "merge")
