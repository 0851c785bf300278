"""Distributed stage-1 two-stage reductions: he2hb and ge2tb on the virtual
mesh, their back-transforms, the band gather and the sharded chase apply.

Counterpart of ``slate_tpu/parallel/dist_twostage.py`` (the reference's
``src/he2hb.cc:207-604``, ``src/ge2tb.cc``, ``src/unmtr_he2hb.cc``,
``src/unmbr_ge2tb.cc`` and ``src/unmtr_hb2st.cc``), with its names, factor
layouts and audited comm bytes.

The panel factorization is REPLICATED and the trailing update DISTRIBUTED:
per panel k every device receives the full (m, nb) panel column (one
rooted column broadcast of the owning column's shards and one all_gather
along the mesh rows) and runs the same offset-pivot panel QR; on one card
that is ONE ``linalg.qr._panel_qr_offset_t`` call per panel, so under
PanelImpl ``pallas``/``auto`` a CUDA panel launches ``csrc/qr_panel.cu``
once per step (``he2hb_dist``: one per panel; ``ge2tb_dist``: the QR panel
and, while more than one column is left, the LQ panel).  The two-sided /
one-sided updates run on every device's flat local matrix, batched over the
(p, q) grid: each local product is one batched GEMM at Highest (no TF32
for f32 on the card) and the ``psum`` over a mesh axis is a sum over the
grid dim, through the audited verbs of ``comm.py``.  Reflectors are stored
as in ``slate_tpu``: ``vq`` (K, p mfl, nb) by mesh row, ``vl`` (K, q nfl,
nb) by mesh column.

Index rules of the reference kept explicitly: where JAX clamps a gather
index (``jnp.minimum(cg, mglob - 1)``) and masks the result, the port
gathers only in-range rows and leaves the rest zero.  LQ steps with at
most one column left are the identity in ``slate_tpu`` (a zero panel whose
factors are multiplied by 0): the port skips their panel and update and
records their collectives, so the audited bytes stay equal.

``gather_diagband`` reads the band's near-diagonal elements straight out of
the tile stack (O(n w) gathers); ``chase_apply_dist`` streams the bulge
chase's sweep blocks from their owners by the two-hop rooted broadcast and
applies them to Z's column shards, which on one card are all of Z.
``num_monitor="on"`` (the he2hb orthogonality gauge) raises until the
numerics half of the observability slice.  ``_he2hb_step`` tags its phases
(``bcast``: the fetch, ``panel``, ``bulk``) for the schedule capture and
the flight recorder (``obs.flight``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..obs.span import instrument
from ..linalg.eig import _chase_sweep_apply, _he2hb_panel_count, _ht
from ..linalg.qr import _panel_qr_offset_t
from ..ops.matmul import _tf32_scope, matmul
from ..types import Precision
from .comm import (
    COL_AXIS,
    ROW_AXIS,
    all_gather_a,
    audit,
    bcast_from_col,
    bcast_from_row,
    bcast_impl_scope,
    flying,
    note_flops,
    phase_scope,
    psum_a,
    resolve_bcast_impl,
)
from .dist import DistMatrix
from .dist_chol import _check_num_monitor
from .dist_qr import _from_flat, _to_flat
from .mesh import mesh_shape


def _to_global_rows(x_loc: torch.Tensor, nparts: int, nb: int, axis_name: str) -> torch.Tensor:
    """All-gather per-device row slices (cyclic tile order) along
    ``axis_name`` into the GLOBAL flat row order: slot r of the gather
    holds logical tiles {i : i % nparts == r} at slot i // nparts.
    ``x_loc`` is (P, Q, mfl, w) with the gathered axis at full size;
    returns (mtl nparts nb, w)."""
    mfl, w = x_loc.shape[-2:]
    mtl = mfl // nb
    ag = all_gather_a(x_loc, axis_name, nparts, axis=0)  # (.., .., nparts, mfl, w)
    ag = ag.reshape(nparts, mtl, nb, w).transpose(0, 1)
    return ag.reshape(mtl * nparts * nb, w)


def _global_ids(nparts: int, tl: int, nb: int, device) -> torch.Tensor:
    """(nparts, tl nb): the global row (column) id of every local flat
    row (column) of each mesh row (column)."""
    r = torch.arange(nparts, device=device).view(nparts, 1, 1)
    i_log = r + torch.arange(tl, device=device).view(1, tl, 1) * nparts
    return (i_log * nb + torch.arange(nb, device=device).view(1, 1, nb)).reshape(nparts, tl * nb)


def _rows_of(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[ids] with rows of ids past x's height zero (the reference's
    clamped-and-masked gather)."""
    ok = ids < x.shape[0]
    out = x[ids.clamp(max=x.shape[0] - 1)]
    return torch.where(ok[..., None], out, 0)


class DistTwoStage(NamedTuple):
    """Stage-1 factors: reflectors sharded along one mesh axis, compact-WY
    accumulators replicated."""

    band: DistMatrix
    vq: torch.Tensor  # (K, p * mfl, nb): global rows, by mesh row
    tq: torch.Tensor  # (K, nb, nb) replicated
    vl: torch.Tensor  # ge2tb only: (K, q * nfl, nb), A's columns by mesh column
    tl: torch.Tensor  # ge2tb only: (K, nb, nb)


def _sub_outer(a_flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
    """a -= x y, in place on the grid's flat local matrices (p, q, M, N)
    with x (p|1, q|1, M, k) and y (p|1, q|1, k, N): one batched GEMM at
    Highest, no temporary of a's size."""
    p, q, mm, nn = a_flat.shape
    k = x.shape[-1]
    xb = x.expand(p, q, mm, k).reshape(p * q, mm, k)
    yb = y.expand(p, q, k, nn).reshape(p * q, k, nn)
    with _tf32_scope(a_flat, Precision.Highest):
        a_flat.view(p * q, mm, nn).baddbmm_(xb, yb, alpha=-1)


# ---------------------------------------------------------------------------
# he2hb: full Hermitian -> band over the mesh (src/he2hb.cc)
# ---------------------------------------------------------------------------


@instrument("he2hb_dist")
def he2hb_dist(a: DistMatrix, bcast_impl: Optional[str] = None,
               num_monitor: Optional[str] = None) -> DistTwoStage:
    """Reduce the full Hermitian DistMatrix (both triangles stored) to a
    Hermitian band of bandwidth nb; Q panels sharded over mesh rows.
    ``bcast_impl`` (Option.BcastImpl) picks the audited panel-broadcast
    lowering (bitwise the same results)."""
    p, q = mesh_shape(a.mesh)
    if a.m != a.n:
        raise ValueError("he2hb_dist needs a square matrix")
    _check_num_monitor(num_monitor, "he2hb_dist")
    nsteps = _he2hb_panel_count(a.n, a.nb)
    nb = a.nb
    flat = _to_flat(a.tiles, p, q)
    mfl = flat.shape[2]
    vqs = torch.zeros((max(nsteps, 1), p * mfl, nb), dtype=a.dtype, device=flat.device)
    tqs = torch.zeros((max(nsteps, 1), nb, nb), dtype=a.dtype, device=flat.device)
    from ..obs import flight as _flight

    bi = resolve_bcast_impl(bcast_impl)
    with bcast_impl_scope(bi), _flight.fly("he2hb", (p, q), nt=nsteps, depth=0, impl=bi):
        for k in range(nsteps):
            _he2hb_step(k, (flat, vqs, tqs), p, q, a.n, nb)
    bt = torch.empty_like(a.tiles)
    _from_flat(flat, bt, p, q)
    band = DistMatrix(tiles=bt, m=a.m, n=a.n, nb=nb, mesh=a.mesh)
    return DistTwoStage(band, vqs, tqs, vqs[:0], tqs[:0])


def _he2hb_fetch(k: int, flat: torch.Tensor, p: int, q: int, nb: int) -> torch.Tensor:
    """Step k's full panel column in global row order, replicated: one
    rooted column broadcast and one row all_gather."""
    kc = k // q
    pcol = flat[:, k % q:k % q + 1, :, kc * nb:(kc + 1) * nb]  # the owning column's shards
    pcol = bcast_from_col(pcol, k % q, q)
    return _to_global_rows(pcol, p, nb, ROW_AXIS)


def _he2hb_panel(k: int, gpan: torch.Tensor, n_true: int, nb: int):
    """Step k's replicated offset panel QR + compact-WY T of the gathered
    column: (R, V, T)."""
    grows = torch.arange(gpan.shape[0], device=gpan.device)
    c0 = k * nb + nb
    masked = torch.where(((grows >= c0) & (grows < n_true))[:, None], gpan, 0)
    r_a, v, _tau, t = _panel_qr_offset_t(masked, c0)
    return r_a, v, t


def _he2hb_update(k: int, carry, gpan: torch.Tensor, pan, p: int, q: int, n_true: int, nb: int):
    """The rest of step k: [history | R; 0] into the panel column and its
    mirror into the panel row, then the distributed two-sided trailing
    update A -= W~ V^H + V W~^H (one psum over 'q', one row all_gather)."""
    flat, vqs, tqs = carry
    r_a, v, t = pan
    _, _, mfl, nfl = flat.shape
    dev, dtype = flat.device, flat.dtype
    rg = _global_ids(p, mfl // nb, nb, dev)  # (p, mfl)
    cg = _global_ids(q, nfl // nb, nb, dev)  # (q, nfl)
    mglob = gpan.shape[0]
    grows = torch.arange(mglob, device=dev)
    j0 = k * nb
    c0 = j0 + nb
    kc, kr = k // q, k // p

    newpan = torch.where((grows >= c0)[:, None], r_a, gpan)
    flat[:, k % q, :, kc * nb:(kc + 1) * nb] = newpan[rg]
    rowblk = flat[k % p, :, kr * nb:(kr + 1) * nb, :]  # (q, nb, nfl)
    mirr = _ht(_rows_of(newpan, cg))  # (q, nb, nfl)
    rowblk.copy_(torch.where((cg >= c0)[:, None, :], mirr, rowblk))

    v_rows = v[rg][:, None]  # (p, 1, mfl, nb)
    v_cols = _rows_of(v, cg)[None]  # (1, q, nfl, nb)
    y = psum_a(matmul(flat, v_cols), COL_AXIS, q)  # (p, 1, mfl, nb)
    y = torch.where((rg >= c0)[:, None, :, None], y, 0).to(dtype)
    yg = _to_global_rows(y, p, nb, ROW_AXIS)
    wmat = matmul(yg, t)
    x = matmul(_ht(t), matmul(_ht(v), wmat))
    wt = (wmat - 0.5 * matmul(v, x)).to(dtype)
    wt_rows = wt[rg][:, None]
    wt_cols = _rows_of(wt, cg)[None]
    _sub_outer(flat, wt_rows, _ht(v_cols))
    _sub_outer(flat, v_rows, _ht(wt_cols))
    vqs[k] = v[rg].reshape(p * mfl, nb)
    tqs[k] = t


def _he2hb_step(k: int, carry, p: int, q: int, n_true: int, nb: int) -> None:
    """One he2hb panel + two-sided trailing update, in place on the carry
    (flat local matrices, vq stack, tq stack), its phases tagged as
    ``slate_tpu``'s (``bcast``: the fetch, ``panel``, ``bulk``).  A
    recording flight counts the panel's Householder flops, 2 m nb^2 -
    2 nb^3 / 3, and the two-sided update's 4 m^2 nb, m = n - (k + 1) nb."""
    mk = n_true - (k + 1) * nb
    with phase_scope("bcast", k):
        gpan = _he2hb_fetch(k, carry[0], p, q, nb)
    with phase_scope("panel", k):
        if flying():
            note_flops(2.0 * mk * nb * nb - 2.0 * nb ** 3 / 3)
        pan = _he2hb_panel(k, gpan, n_true, nb)
    with phase_scope("bulk", k):
        if flying():
            note_flops(4.0 * mk * mk * nb)
        _he2hb_update(k, carry, gpan, pan, p, q, n_true, nb)


def _apply_row_panels(vqs: torch.Tensor, tqs: torch.Tensor, z: DistMatrix, p: int, q: int,
                      adjoint: bool) -> DistMatrix:
    """Z <- Q Z (or Q^H Z) for row-sharded panels: one psum along 'p' a
    panel, the reflectors read from their own shards."""
    nsteps = vqs.shape[0]
    zf = _to_flat(z.tiles, p, q)
    mfl = zf.shape[2]
    for i in range(nsteps):
        k = i if adjoint else nsteps - 1 - i
        v = vqs[k].view(p, 1, mfl, -1)
        t = _ht(tqs[k]) if adjoint else tqs[k]
        w1 = psum_a(matmul(_ht(v), zf), ROW_AXIS, p)  # (1, q, nb, nfl)
        _sub_outer(zf, v, matmul(t, w1))
    out = torch.empty_like(z.tiles)
    _from_flat(zf, out, p, q)
    return DistMatrix(tiles=out, m=z.m, n=z.n, nb=z.nb, mesh=z.mesh)


@instrument("unmtr_he2hb_dist")
def unmtr_he2hb_dist(f: DistTwoStage, z: DistMatrix, adjoint: bool = False) -> DistMatrix:
    """Z <- Q Z (or Q^H Z) for the distributed stage-1 Q
    (src/unmtr_he2hb.cc)."""
    p, q = mesh_shape(z.mesh)
    if f.band.mt != z.mt or f.band.nb != z.nb:
        raise ValueError("unmtr_he2hb_dist operand mismatch")
    return _apply_row_panels(f.vq, f.tq, z, p, q, adjoint)


# ---------------------------------------------------------------------------
# ge2tb: general -> upper triangular band over the mesh (src/ge2tb.cc)
# ---------------------------------------------------------------------------


@instrument("ge2tb_dist")
def ge2tb_dist(a: DistMatrix) -> DistTwoStage:
    """Reduce a general (m >= n) DistMatrix to an upper triangular band of
    bandwidth nb by alternating distributed QR/LQ panels; U-side
    reflectors sharded over 'p', V-side over 'q'."""
    p, q = mesh_shape(a.mesh)
    if a.m < a.n:
        raise ValueError(f"ge2tb_dist requires m >= n, got {a.m}x{a.n}")
    nb = a.nb
    nblocks = -(-a.n // nb)
    flat = _to_flat(a.tiles, p, q)
    _, _, mfl, nfl = flat.shape
    dev, dtype = flat.device, flat.dtype
    rg = _global_ids(p, mfl // nb, nb, dev)
    cg = _global_ids(q, nfl // nb, nb, dev)
    grows = torch.arange(mfl * p, device=dev)
    gcols = torch.arange(nfl * q, device=dev)
    vqs = torch.zeros((nblocks, p * mfl, nb), dtype=dtype, device=dev)
    tqs = torch.zeros((nblocks, nb, nb), dtype=dtype, device=dev)
    vls = torch.zeros((nblocks, q * nfl, nb), dtype=dtype, device=dev)
    tls = torch.zeros((nblocks, nb, nb), dtype=dtype, device=dev)
    item = torch.empty((), dtype=dtype).element_size()
    for k in range(nblocks):
        j0, j1 = k * nb, k * nb + nb
        kc, kr = k // q, k // p
        # ---- QR panel: eliminate below the diagonal of block column k ----
        pcol = bcast_from_col(flat[:, k % q:k % q + 1, :, kc * nb:(kc + 1) * nb], k % q, q)
        gpan = _to_global_rows(pcol, p, nb, ROW_AXIS)
        masked = torch.where(((grows >= j0) & (grows < a.m))[:, None], gpan, 0)
        r_a, vq, _tau, tq = _panel_qr_offset_t(masked, j0)
        # left trailing update on the columns >= j1: A -= Vq Tq^H (Vq^H A)
        vq_rows = vq[rg][:, None]
        w1 = psum_a(matmul(_ht(vq_rows), flat), ROW_AXIS, p)  # (1, q, nb, nfl)
        y = torch.where((cg >= j1)[:, None, :], matmul(_ht(tq), w1), 0)
        _sub_outer(flat, vq_rows, y)
        newpan = torch.where((grows >= j0)[:, None], r_a, gpan)
        flat[:, k % q, :, kc * nb:(kc + 1) * nb] = newpan[rg]

        # ---- LQ panel on block row k (the QR of its conj transpose) ----
        lq_active = j1 < a.n - 1
        rowb = bcast_from_row(flat[k % p:k % p + 1, :, kr * nb:(kr + 1) * nb, :], k % p, p)
        growb = _to_global_rows(_ht(rowb), q, nb, COL_AXIS)  # (nglob, nb)
        if lq_active:
            maskedh = torch.where((gcols >= j1)[:, None], growb, 0)
            l_a, vl, _taul, tl = _panel_qr_offset_t(maskedh, j1)
            # right trailing update on the rows >= j1: A -= (A Vl) Tl Vl^H
            vl_cols = _rows_of(vl, cg)[None]  # (1, q, nfl, nb)
            w2 = psum_a(matmul(flat, vl_cols), COL_AXIS, q)  # (p, 1, mfl, nb)
            w2 = torch.where((rg >= j1)[:, None, :, None], matmul(w2, tl), 0)
            _sub_outer(flat, w2, _ht(vl_cols))
            rowblk = flat[k % p, :, kr * nb:(kr + 1) * nb, :]
            rowblk.copy_(torch.where((cg >= j1)[:, None, :], _ht(_rows_of(l_a, cg)), rowblk))
            vls[k] = _rows_of(vl, cg).reshape(q * nfl, nb)
            tls[k] = tl
        else:
            # slate_tpu's zero panel: its A Vl psum moves bytes all the same
            audit(f"psum[{COL_AXIS}]", mfl * nb * item)
        vqs[k] = vq[rg].reshape(p * mfl, nb)
        tqs[k] = tq
    bt = torch.empty_like(a.tiles)
    _from_flat(flat, bt, p, q)
    band = DistMatrix(tiles=bt, m=a.m, n=a.n, nb=nb, mesh=a.mesh)
    return DistTwoStage(band, vqs, tqs, vls, tls)


@instrument("unmbr_ge2tb_u_dist")
def unmbr_ge2tb_u_dist(f: DistTwoStage, z: DistMatrix, adjoint: bool = False) -> DistMatrix:
    """Z <- Q Z for the stage-1 U factor (src/unmbr_ge2tb.cc U side): the
    panel apply of ``unmtr_he2hb_dist``."""
    p, q = mesh_shape(z.mesh)
    if f.band.mt != z.mt or f.band.nb != z.nb:
        raise ValueError("unmbr_ge2tb_u_dist operand mismatch")
    return _apply_row_panels(f.vq, f.tq, z, p, q, adjoint)


@instrument("unmbr_ge2tb_v_dist")
def unmbr_ge2tb_v_dist(f: DistTwoStage, z: DistMatrix) -> DistMatrix:
    """Z <- P Z for the stage-1 V factor: the reflectors live in A's column
    space (sharded over 'q') while Z's rows are sharded over 'p', so each
    panel is re-gathered to global order and sliced by Z's row ids (one
    all_gather + one psum a panel)."""
    p, q = mesh_shape(z.mesh)
    if f.band.nt * f.band.nb != z.mt * z.nb or f.band.nb != z.nb:
        raise ValueError("unmbr_ge2tb_v_dist operand mismatch")
    nsteps = f.vl.shape[0]
    zf = _to_flat(z.tiles, p, q)
    mfl = zf.shape[2]
    nb = z.nb
    rg = _global_ids(p, mfl // nb, nb, zf.device)
    for i in range(nsteps):
        k = nsteps - 1 - i
        vl_loc = f.vl[k].view(1, q, -1, nb)
        gvl = _to_global_rows(vl_loc, q, nb, COL_AXIS)
        v = _rows_of(gvl, rg)[:, None]  # (p, 1, mfl, nb)
        w1 = psum_a(matmul(_ht(v), zf), ROW_AXIS, p)
        _sub_outer(zf, v, matmul(f.tl[k], w1))
    out = torch.empty_like(z.tiles)
    _from_flat(zf, out, p, q)
    return DistMatrix(tiles=out, m=z.m, n=z.n, nb=z.nb, mesh=z.mesh)


# ---------------------------------------------------------------------------
# Stage 2 distribution: the band travels as O(n w) diagonals, the chase's
# reflector family is sharded over all p q devices and streamed one sweep
# block at a time to Z's column shards (reference src/unmtr_hb2st.cc).
# ---------------------------------------------------------------------------


def gather_diagband(band: DistMatrix, w: int) -> torch.Tensor:
    """Diagonal-band storage (m, 4w) of the distributed band matrix,
    replicated: out[i, dd] = A[i, i + dd - 2w] (zero outside the padded
    matrix).  ``slate_tpu`` scatters each device's near-diagonal elements
    into the frame and sums over both mesh axes (the audited psum); here
    the elements are gathered straight out of the tile stack."""
    p, q = mesh_shape(band.mesh)
    t = band.tiles
    mt, nt, nb, _ = t.shape
    mtl, ntl = mt // p, nt // q
    D = 4 * w
    dev = t.device
    audit(f"psum[{(ROW_AXIS, COL_AXIS)}]", mtl * p * nb * D * t.element_size())
    i = torch.arange(band.m, device=dev)[:, None]
    j = i + torch.arange(D, device=dev)[None, :] - 2 * w
    ok = (j >= 0) & (j < nt * nb)
    jc = j.clamp(0, nt * nb - 1)
    ti, tj = i // nb, jc // nb
    vals = t[(ti % p) * mtl + ti // p, (tj % q) * ntl + tj // q, i % nb, jc % nb]
    return torch.where(ok, vals, 0)


@instrument("chase_apply_dist")
def chase_apply_dist(vs: torch.Tensor, taus: torch.Tensor, z: torch.Tensor, n: int, w: int, mesh,
                     bcast_impl: Optional[str] = None) -> torch.Tensor:
    """Z <- U Z for a bulge-chase reflector basis with Z column-sharded
    over ALL p q devices and the (sweep, hop) family sharded by sweep
    blocks: block b travels from its owner (b // q, b % q) by the two-hop
    rooted broadcast (along the rows from mesh row b // q, then along the
    columns from mesh column b % q), in reverse block order, and is applied
    to every column shard.  On one card the column shards are all of Z, so
    each block is one ``_chase_sweep_apply`` on Z; the padded sweeps past
    the family's end (tau = 0) are the identity and are not run."""
    p, q = mesh_shape(mesh)
    nparts = p * q
    nsweeps, max_hops, wv = vs.shape
    assert wv == w
    blk = -(-nsweeps // nparts)
    pad = blk * nparts - nsweeps
    vs_p = torch.nn.functional.pad(vs, (0, 0, 0, 0, 0, pad)).view(p, q, blk, max_hops, w)
    ta_p = torch.nn.functional.pad(taus, (0, 0, 0, pad)).view(p, q, blk, max_hops)
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        for b in range(nparts):
            src = nparts - 1 - b  # reverse chronological block order
            vs_b = bcast_from_col(bcast_from_row(vs_p, src // q, p), src % q, q)[0, 0]
            ta_b = bcast_from_col(bcast_from_row(ta_p, src // q, p), src % q, q)[0, 0]
            live = min(blk, nsweeps - src * blk)
            if live > 0:
                z = _chase_sweep_apply(vs_b[:live], ta_b[:live], z, n, w, False, j0=src * blk)
    return z
