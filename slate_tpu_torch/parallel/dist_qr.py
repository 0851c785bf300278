"""Distributed CAQR (communication-avoiding QR) over the block-cyclic virtual mesh.

Counterpart of ``slate_tpu/parallel/dist_qr.py`` (the reference's
``src/geqrf.cc:191-230`` and the ttqrt tree ``internal_ttqrt.cc``).  Per
tile-column panel k:

1. each mesh row factors its local stack of panel tiles with one
   offset-pivot Householder QR (``_qr_panel_factor``), giving a local R at
   its first valid tile slot and reflectors below it;
2. the factors go along the mesh columns (``_qr_panel_bcast``: three
   rooted broadcasts) and every device applies the local compact-WY update
   to its trailing columns; the per-row R factors are gathered over the
   mesh rows and merged by a binary tree of (2nb, nb) QRs, whose reflectors
   then update the gathered R-row slices of the trailing columns
   (``_qr_panel_update``).

On one card a panel is factored once per mesh row of the owning column:
``slate_tpu`` factors a masked (zero) panel on every other device and
throws the result away (``jnp.where(mine_c, ..., 0)``), which gives the same
bits.  Under ``Option.PanelImpl`` ``pallas``/``auto`` the owning column's p
panels go through ONE ``ops.kernels.qr_panel_offset`` launch per step (the
hand-written ``csrc/qr_panel.cu`` on the card), and each tree merge through
``ops.kernels.qr_panel`` (the same kernel's plain form: the merge is
``slate_tpu``'s ``_panel_qr`` + ``_larft`` pair, which is what that kernel
computes), so both QR kernels sit on the mesh path: nt offset-panel launches
and nt (p - 1) merge launches per ``geqrf_dist``; a bf16/f16 panel is
factored in f32 and cast back.  ``xla`` and complex panels take the plain
pairs.

The device-local arithmetic runs on each device's stack as one flat
(mfl, ntl nb) matrix (one copy in, one out); the trailing update touches
only the window of local rows and columns that step k can change, where
``slate_tpu`` computes the full width and masks it.  The audited verbs move
``slate_tpu``'s payloads: three column broadcasts, the gather of the R
blocks and the gather of the full-width R-row slices per step.

Factor storage mirrors ``slate_tpu``: V packed below the R slots inside the
tiles, the per-(mesh row, panel) T_loc stack, and the replicated tree
factors.  ``unmqr_dist`` replays them against a conformal B.
``num_monitor="on"`` (the ``_qr_orth_loss`` gauge) comes with the numerics
half of the observability slice.  :func:`_qr_panel_step` tags its phases
(``panel``, ``bcast``, ``bulk``) for the schedule capture and the flight
recorder (``obs.flight``).  The checkpointed chain
(``ft.ckpt.geqrf_ckpt``) runs :func:`_qr_panel_step` over a step range on
the same carry.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..obs.span import instrument
from ..linalg.qr import _panel_qr_offset_t, _panel_qr_t, _v_of
from ..ops.kernels import panel_impl_scope, resolve_panel_impl
from ..ops.matmul import matmul
from ..types import Op
from .comm import (
    ROW_AXIS,
    all_gather_a,
    bcast_from_col,
    bcast_impl_scope,
    flying,
    note_flops,
    phase_scope,
    resolve_bcast_impl,
)
from .dist import DistMatrix, local_view
from .dist_chol import _check_num_monitor
from .mesh import mesh_shape


class DistQR(NamedTuple):
    """Distributed CAQR factors: ``fact`` holds R in the upper triangle and
    the local-QR reflectors packed below their R slots; ``tloc`` the
    per-(mesh row, panel) WY accumulators, (p * nt, nb, nb) with mesh row
    r's stack at [r * nt:(r + 1) * nt]; ``treev``/``treet`` the merge
    reflectors, (nt, max(1, p), 2nb, nb) and (nt, max(1, p), nb, nb),
    indexed by (panel, merge id in tree order)."""

    fact: DistMatrix
    tloc: torch.Tensor
    treev: torch.Tensor
    treet: torch.Tensor


def _tree_rounds(p: int) -> List[List[Tuple[int, int]]]:
    """Static binary-merge schedule over p participants."""
    rounds, d = [], 1
    while d < p:
        rounds.append([(r, r + d) for r in range(0, p, 2 * d) if r + d < p])
        d *= 2
    return rounds


def _merge_ids(p: int) -> List[List[int]]:
    """Merge-id numbering matching _tree_rounds order."""
    ids, nxt = [], 0
    for rnd in _tree_rounds(p):
        ids.append(list(range(nxt, nxt + len(rnd))))
        nxt += len(rnd)
    return ids


def _local_panel_geometry(k: int, r: int, p: int, mtl: int, nb: int) -> Tuple[int, bool]:
    """(row0, has_rows) of mesh row r for panel k: the start of its first
    valid tile slot in the local flat row space, and whether it owns any
    panel rows."""
    s0 = max(0, -(-(k - r) // p))  # ceil((k - r) / p), >= 0
    return min(s0, mtl - 1) * nb, s0 < mtl


def _geometry(k: int, p: int, mtl: int, nb: int):
    geo = [_local_panel_geometry(k, r, p, mtl, nb) for r in range(p)]
    return [g[0] for g in geo], [g[1] for g in geo]


def _valid_rows(k: int, p: int, mtl: int, nb: int, m_true: int, device) -> torch.Tensor:
    """(p, mfl): local flat rows of each mesh row that hold global rows
    k nb <= g < m_true."""
    r = torch.arange(p, device=device).view(p, 1, 1)
    i_log = r + torch.arange(mtl, device=device).view(1, mtl, 1) * p
    gid = (i_log * nb + torch.arange(nb, device=device).view(1, 1, nb)).reshape(p, mtl * nb)
    return (gid >= k * nb) & (gid < m_true)


def _v_replay(panel_flat: torch.Tensor, row0: torch.Tensor, nb: int) -> torch.Tensor:
    """Reconstruct the local-QR reflectors from packed panel storage
    (..., mfl, nb): strictly below the pivot rows, unit diagonal at
    row0 + j; ``row0`` broadcasts against (..., 1, 1)."""
    mfl = panel_flat.shape[-2]
    fr = torch.arange(mfl, device=panel_flat.device)[:, None]
    cj = torch.arange(nb, device=panel_flat.device)[None, :]
    piv = row0 + cj
    v = torch.where(fr > piv, panel_flat, 0)
    return v + (fr == piv).to(panel_flat.dtype)


def _rot(k: int, p: int) -> List[int]:
    """Participant rotation placing the panel's diagonal-owner mesh row at
    tree position 0, so the merged R collapses onto the diagonal tile."""
    return [(k % p + i) % p for i in range(p)]


def _apply_tree_tops(tops: torch.Tensor, treev_k: torch.Tensor, treet_k: torch.Tensor, k: int,
                     p: int, nb: int, adjoint: bool) -> torch.Tensor:
    """Apply the panel's merge tree to the gathered R-row slices
    (..., p, nb, w), ordered by mesh row.  adjoint=True applies Q_tree^H
    (rounds ascending), False applies Q_tree (rounds descending)."""
    rot = _rot(k, p)
    tops = tops[..., rot, :, :].clone()
    rounds, mids = _tree_rounds(p), _merge_ids(p)
    order = range(len(rounds)) if adjoint else range(len(rounds) - 1, -1, -1)
    for d in order:
        for (root, partner), mid in zip(rounds[d], mids[d]):
            v2 = treev_k[mid]  # (2nb, nb)
            t2 = treet_k[mid].conj().T if adjoint else treet_k[mid]
            stacked = torch.cat([tops[..., root, :, :], tops[..., partner, :, :]], dim=-2)
            w = matmul(v2.conj().T, stacked)
            stacked = stacked - matmul(matmul(v2, t2), w).to(stacked.dtype)
            tops[..., root, :, :] = stacked[..., :nb, :]
            tops[..., partner, :, :] = stacked[..., nb:, :]
    inv = [rot.index(i) for i in range(p)]
    return tops[..., inv, :, :]


def _to_flat(tiles: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """The cyclic stack as every device's flat local matrix, (p, q, mtl nb,
    ntl nb) (one copy)."""
    loc = local_view(tiles, p, q)
    pp, qq, mtl, ntl, nb, _ = loc.shape
    return loc.permute(0, 1, 2, 4, 3, 5).reshape(pp, qq, mtl * nb, ntl * nb)


def _from_flat(flat: torch.Tensor, tiles: torch.Tensor, p: int, q: int) -> None:
    loc = local_view(tiles, p, q)
    _, _, mtl, ntl, nb, _ = loc.shape
    loc.copy_(flat.view(p, q, mtl, nb, ntl, nb).permute(0, 1, 2, 4, 3, 5))


def _qr_panel_factor(k: int, flat: torch.Tensor, p: int, q: int, nb: int, m_true: int):
    """Local panel QR of step k on the owning mesh column: each mesh row's
    valid panel rows through the offset-pivot panel QR plus its T, all p
    panels in one dispatch.  Returns (r_a, v, T_loc), each (p, 1, ...)."""
    mtl = flat.shape[2] // nb
    kc, c0 = k // q, k % q
    row0s, _ = _geometry(k, p, mtl, nb)
    valid = _valid_rows(k, p, mtl, nb, m_true, flat.device)
    pcol = flat[:, c0, :, kc * nb:(kc + 1) * nb]
    masked = torch.where(valid[..., None], pcol, 0)
    r_a, v, _tau, tl = _panel_qr_offset_t(masked, row0s)
    return r_a[:, None], v[:, None], tl[:, None]


def _qr_panel_bcast(pan_own, k: int, q: int):
    """Share step k's panel factors across the mesh columns: three rooted
    column broadcasts (the comm-audit volume of the CAQR bcast phase)."""
    return tuple(bcast_from_col(x, k % q, q) for x in pan_own)


def _trailing_cols(k: int, q: int, ntl: int, nb: int, device):
    """(first flat column of the trailing window, its (1, q, 1, W) mask of
    logical column tiles > k)."""
    s0c = min(max(0, -(-(k + 1 - c) // q)) for c in range(q))
    s0c = min(s0c, ntl)
    c = torch.arange(q, device=device).view(q, 1)
    j_log = c + torch.arange(s0c, ntl, device=device).view(1, -1) * q
    mask = (j_log > k).repeat_interleave(nb, dim=1)  # (q, W)
    return s0c * nb, mask[None, :, None, :]


def _qr_panel_update(k: int, carry, pan, p: int, q: int, nb: int, m_true: int):
    """The rest of panel step k on the broadcast factors: the packed V\\R
    write, the local compact-WY trailing update, the tree merge of the
    per-row R factors and the tree update of the gathered R-row slices."""
    flat, tls, tvs, tts = carry
    r_a, v, tl = pan
    mfl, wfl = flat.shape[2], flat.shape[3]
    mtl, ntl = mfl // nb, wfl // nb
    dev, dtype = flat.device, flat.dtype
    kc, c0 = k // q, k % q
    row0s, has = _geometry(k, p, mtl, nb)
    valid = _valid_rows(k, p, mtl, nb, m_true, dev)

    # ---- write packed V\R into the owning column's panel ----
    fr = torch.arange(mfl, device=dev)[None, :, None]
    cj = torch.arange(nb, device=dev)[None, None, :]
    piv = torch.tensor(row0s, device=dev).view(p, 1, 1) + cj
    pcol = flat[:, c0, :, kc * nb:(kc + 1) * nb]
    packed = r_a[:, 0] + torch.where(fr > piv, v[:, 0], 0)
    pcol.copy_(torch.where(valid[..., None], packed, pcol))

    # ---- local trailing update C -= V T^H (V^H C) on the columns > k, in
    # the window of rows at or below the first pivot (V is zero above) ----
    rlo = min(row0s)
    clo, cmask = _trailing_cols(k, q, ntl, nb, dev)
    if clo < wfl:
        cw = flat[:, :, rlo:, clo:]
        vw = v[:, :, rlo:]
        w1 = matmul(vw.conj().transpose(-1, -2), cw)  # (p, q, nb, W)
        y = torch.where(cmask, matmul(tl.conj().transpose(-1, -2), w1), 0)
        # in place through a (p q, R, W) view of the window: no product temp
        cw.view(p * q, cw.shape[2], cw.shape[3]).baddbmm_(
            vw.expand(p, q, -1, -1).reshape(p * q, -1, nb), y.reshape(p * q, nb, -1), alpha=-1)

    # ---- tree merge of the per-row local R factors, in rotated
    # participant order (diag owner = tree root) ----
    rblk = torch.stack([r_a[r, 0, row0s[r]:row0s[r] + nb].triu() if has[r]
                        else torch.zeros((nb, nb), dtype=dtype, device=dev) for r in range(p)])
    rs = all_gather_a(rblk[:, None], ROW_AXIS, p)[0, 0][_rot(k, p)].clone()  # (p, nb, nb)
    nmerge = tvs.shape[1]
    tv = torch.zeros((nmerge, 2 * nb, nb), dtype=dtype, device=dev)
    tt = torch.zeros((nmerge, nb, nb), dtype=dtype, device=dev)
    for rnd, midl in zip(_tree_rounds(p), _merge_ids(p)):
        for (root, partner), mid in zip(rnd, midl):
            vr2, _tau2, t2 = _panel_qr_t(torch.cat([rs[root], rs[partner]], dim=0))
            tv[mid] = _v_of(vr2)
            tt[mid] = t2
            rs[root] = vr2[:nb].triu()

    # ---- tree update on the gathered R-row slices of C (columns > k;
    # earlier columns hold finished R/V history) ----
    myrow = torch.stack([flat[r, :, row0s[r]:row0s[r] + nb] for r in range(p)])  # (p, q, nb, wfl)
    hasm = torch.tensor(has, device=dev).view(p, 1, 1, 1)
    tops = all_gather_a(torch.where(hasm, myrow, 0), ROW_AXIS, p)[0]  # (q, p, nb, wfl)
    tops = _apply_tree_tops(tops, tv, tt, k, p, nb, adjoint=True)
    colmask = torch.zeros((q, wfl), dtype=torch.bool, device=dev)
    colmask[:, clo:] = cmask[0, :, 0]
    for r in range(p):
        if has[r]:
            flat[r, :, row0s[r]:row0s[r] + nb] = torch.where(colmask[:, None, :], tops[:, r], myrow[r])
    # the diag owner overwrites its R slot's upper triangle with the
    # tree-final R (its V entries below stay)
    rd = k % p
    blk = flat[rd, c0, row0s[rd]:row0s[rd] + nb, kc * nb:(kc + 1) * nb]
    tri = torch.ones((nb, nb), dtype=torch.bool, device=dev).triu()
    blk.copy_(torch.where(tri, rs[0], blk))
    tls[:, k] = tl[:, 0]
    tvs[k] = tv
    tts[k] = tt


def _qr_panel_step(k: int, carry, p: int, q: int, nb: int, m_true: int) -> None:
    """One CAQR panel step of the strict schedule, in place on the carry
    (flat local matrices, T_loc stack, tree-V stack, tree-T stack), its
    phases tagged as ``slate_tpu``'s (``panel``, ``bcast``, ``bulk``).  A
    recording flight counts the panel's Householder flops, 2 m w^2 -
    2 w^3 / 3, and the update's compact-WY ones, 4 m w n' - 2 w^2 n', on
    the padded trailing m x n'."""
    if flying():
        mk = p * carry[0].shape[2] - k * nb
        nk = max(0, q * carry[0].shape[3] - (k + 1) * nb)
    with phase_scope("panel", k):
        if flying():
            note_flops(2.0 * mk * nb * nb - 2.0 * nb ** 3 / 3)
        pan_own = _qr_panel_factor(k, carry[0], p, q, nb, m_true)
    with phase_scope("bcast", k):
        pan = _qr_panel_bcast(pan_own, k, q)
    with phase_scope("bulk", k):
        if flying():
            note_flops(4.0 * mk * nb * nk - 2.0 * nb * nb * nk)
        _qr_panel_update(k, carry, pan, p, q, nb, m_true)


def _qr_pad_identity(tiles: torch.Tensor, p: int, q: int, n_true: int) -> None:
    """Ones on the padded diagonal (global index >= n_true) so that R
    solves stay nonsingular, in place on the cyclic stack."""
    mt, nt, nb, _ = tiles.shape
    mtl, ntl = mt // p, nt // q
    for g in range(n_true // nb, nt):
        t = tiles[(g % p) * mtl + g // p, (g % q) * ntl + g // q]
        e = torch.arange(nb, device=tiles.device)
        pad = e[g * nb + e >= n_true]
        t[pad, pad] = 1


@instrument("geqrf_dist")
def geqrf_dist(a: DistMatrix, bcast_impl: Optional[str] = None, panel_impl: Optional[str] = None,
               num_monitor: Optional[str] = None, overwrite_a: bool = False) -> DistQR:
    """Factor A = Q R across the mesh (m >= n).  ``bcast_impl``
    (Option.BcastImpl) picks the audited panel-broadcast lowering (bitwise
    the same results), ``panel_impl`` (Option.PanelImpl) the panel
    lowering: the kernel wrappers (``pallas``/``auto``) or the plain pairs
    (``xla``).  ``overwrite_a`` writes the factor into ``a``'s tile stack
    instead of a new one."""
    p, q = mesh_shape(a.mesh)
    if a.m < a.n:
        raise ValueError(f"geqrf_dist requires m >= n, got {a.m}x{a.n}")
    _check_num_monitor(num_monitor, "geqrf_dist")
    nt, nb, dtype, dev = a.nt, a.nb, a.dtype, a.tiles.device
    nmerge = max(1, p)
    flat = _to_flat(a.tiles, p, q)
    tls = torch.zeros((p, nt, nb, nb), dtype=dtype, device=dev)
    tvs = torch.zeros((nt, nmerge, 2 * nb, nb), dtype=dtype, device=dev)
    tts = torch.zeros((nt, nmerge, nb, nb), dtype=dtype, device=dev)
    from ..obs import flight as _flight

    bi = resolve_bcast_impl(bcast_impl)
    with bcast_impl_scope(bi), panel_impl_scope(resolve_panel_impl(panel_impl)), \
            _flight.fly("geqrf", (p, q), nt=nt, depth=0, impl=bi):
        for k in range(nt):
            _qr_panel_step(k, (flat, tls, tvs, tts), p, q, nb, a.m)
    tiles = a.tiles if overwrite_a else torch.empty_like(a.tiles)
    _from_flat(flat, tiles, p, q)
    del flat
    _qr_pad_identity(tiles, p, q, a.n)
    fd = DistMatrix(tiles=tiles, m=a.m, n=a.n, nb=nb, mesh=a.mesh, diag_pad=True)
    return DistQR(fd, tls.reshape(p * nt, nb, nb), tvs, tts)


@instrument("unmqr_dist")
def unmqr_dist(f: DistQR, b: DistMatrix, op: Op = Op.ConjTrans,
               bcast_impl: Optional[str] = None) -> DistMatrix:
    """B <- Q^H B (op=ConjTrans) or Q B (any other op, as ``slate_tpu``)
    from CAQR factors; a new tile stack.  ``bcast_impl`` as in
    :func:`geqrf_dist`."""
    a = f.fact
    p, q = mesh_shape(a.mesh)
    if b.mt != a.mt or b.nb != a.nb or b.grid != a.grid:
        raise ValueError("unmqr_dist operand mismatch")
    nt, nb = a.nt, a.nb
    mtl = a.mt // p
    adjoint = op == Op.ConjTrans
    loc_a = local_view(a.tiles, p, q)
    tls = f.tloc.view(p, nt, nb, nb)
    bflat = _to_flat(b.tiles, p, q)
    dev = bflat.device
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        for s in range(nt):
            k = s if adjoint else nt - 1 - s
            kc, c0 = k // q, k % q
            row0s, has = _geometry(k, p, mtl, nb)
            valid = _valid_rows(k, p, mtl, nb, a.m, dev)
            pflat = loc_a[:, c0, :, kc].reshape(p, mtl * nb, nb)
            pflat = bcast_from_col(torch.where(valid[..., None], pflat, 0)[:, None], c0, q)
            r0 = torch.tensor(row0s, device=dev).view(p, 1, 1, 1)
            v = torch.where(valid[:, None, :, None], _v_replay(pflat, r0, nb), 0)  # (p, 1, mfl, nb)
            tl = tls[:, k][:, None]
            t_eff = tl.conj().transpose(-1, -2) if adjoint else tl

            def local_apply(bf):
                w1 = matmul(v.conj().transpose(-1, -2), bf)
                return bf - matmul(v, matmul(t_eff, w1)).to(bf.dtype)

            def tree_apply(bf):
                # gather a zeroed copy for rowless devices, but keep their
                # untouched rows on write-back
                myrow = torch.stack([bf[r, :, row0s[r]:row0s[r] + nb] for r in range(p)])
                hasm = torch.tensor(has, device=dev).view(p, 1, 1, 1)
                tops = all_gather_a(torch.where(hasm, myrow, 0), ROW_AXIS, p)[0]
                tops = _apply_tree_tops(tops, f.treev[k], f.treet[k], k, p, nb, adjoint=adjoint)
                bf = bf.clone()
                for r in range(p):
                    if has[r]:
                        bf[r, :, row0s[r]:row0s[r] + nb] = tops[:, r]
                return bf

            if adjoint:  # Q^H = Q_tree^H Q_loc^H
                bflat = tree_apply(local_apply(bflat))
            else:  # Q = Q_loc Q_tree
                bflat = local_apply(tree_apply(bflat))
    out = torch.empty_like(b.tiles)
    _from_flat(bflat, out, p, q)
    return DistMatrix(tiles=out, m=b.m, n=b.n, nb=b.nb, mesh=b.mesh)
