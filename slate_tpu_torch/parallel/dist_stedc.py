"""Distributed tridiagonal divide and conquer (stedc) over the virtual mesh.

Counterpart of ``slate_tpu/parallel/dist_stedc.py`` (the reference's
``src/stedc.cc:16-150`` with ``stedc_merge.cc``, ``stedc_secular.cc`` and
``stedc_deflate.cc``), with its layout, row interleave and audited bytes.
Per level (merge width 2s, m merges):

- eigenvalues and the O(n) merge vectors (z, deflation rotations, active
  masks, converged roots) are replicated;
- the eigenvector stack holds, per merge block, each mesh row's row shard
  with full columns, (m, 2s/p, s), built recursively as [child0's shard;
  child1's shard], so block row 0 lives on mesh row 0 and block row 2s - 1
  on mesh row p - 1: the boundary rows a parent merge needs come by two
  rooted row broadcasts from those static owners;
- the secular roots are sharded over the mesh columns (device column c
  owns roots [c 2s/q, (c + 1) 2s/q)), the converged roots and z-hat are
  all_gathered back along the columns, and each device assembles its rows
  x its root columns, all_gathered along the columns to full columns.

On one card the grid's column shards of a level are computed together:
the root finder and z-hat run on all 2s roots at once (the same
arithmetic per root as ``linalg.tridiag._secular_roots_shard`` /
``_zhat_shard``, which they are), and the assembly is one batched product
over the mesh rows; the verbs record what the p x q mesh would move.  The
finale un-interleaves the rows and sorts the eigencolumns, landing Z in
``chase_apply_dist``'s column-shard order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..obs.span import instrument
from ..linalg.tridiag import (
    _DC_SMALL,
    _deflate_z,
    _levels,
    _secular_roots_shard,
    _undo_deflation_rows,
    _zhat_shard,
    stedc,
    steqr,
)
from ..ops.matmul import matmul
from .comm import COL_AXIS, ROW_AXIS, all_gather_a, bcast_from_row, bcast_impl_scope, resolve_bcast_impl
from .mesh import mesh_shape


@instrument("stedc_dist")
def stedc_dist(d: torch.Tensor, e: torch.Tensor, mesh, bcast_impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigen-decomposition of the symmetric tridiagonal (d, e) with the
    merge tree sharded over ``mesh``: (w ascending, Z (n, n)).  A tiny
    problem, or a mesh that does not divide the tree (``_DC_SMALL % p`` or
    ``2 _DC_SMALL % q``), takes the replicated ``stedc``.  ``bcast_impl``
    (Option.BcastImpl) lowers the boundary-row broadcasts (bitwise the
    same results)."""
    p, q = mesh_shape(mesh)
    n = d.shape[0]
    if n <= max(_DC_SMALL, 2) or _DC_SMALL % p or (2 * _DC_SMALL) % q:
        return stedc(d, e)
    dtype, dev = d.dtype, d.device
    _, N = _levels(n)
    nblk = N // _DC_SMALL
    scale = d.abs().max() + 2 * (e.abs().max() if n > 1 else 0) + 1
    big = 4 * scale
    dp = torch.cat([d, torch.ones(N - n, dtype=dtype, device=dev) * big])
    ep = torch.cat([e, torch.zeros(N - 1 - (n - 1), dtype=dtype, device=dev)])
    seams = _DC_SMALL * torch.arange(1, nblk, device=dev) - 1
    dp[seams] += -ep[seams]
    dp[seams + 1] += -ep[seams]
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        w, z = _stedc_dist_levels(dp, ep, p, q, N)
    # the row interleave of the recursive [child0-shard; child1-shard]
    # stacking: stacked row j holds global row perm_rows[j]
    perm_rows = stacked_rows(p, N)
    inv = torch.as_tensor(np.argsort(perm_rows, kind="stable"), device=dev)
    order = torch.argsort(w[:n], stable=True)
    z = _stedc_finale(z, inv, order, p, q, n)
    return w[:n][order], z


def stacked_rows(p: int, N: int) -> np.ndarray:
    """The global row of every stacked row of the merge tree's final
    block: device row r's local rows are ids_r = U_l (s_l + ids_{l-1}),
    concatenated over r."""
    rp0 = _DC_SMALL // p
    rows_global = []
    for r_ in range(p):
        ids = np.arange(r_ * rp0, (r_ + 1) * rp0)
        s_ = _DC_SMALL
        while s_ < N:
            ids = np.concatenate([ids, s_ + ids])
            s_ *= 2
        rows_global.append(ids)
    return np.concatenate(rows_global)


def _col_allgather(x: torch.Tensor, q: int) -> torch.Tensor:
    """All_gather the root shards (m, 2s) -- device column c holding the
    columns [c 2s/q, (c + 1) 2s/q) -- back to the full replicated (m, 2s),
    in device-column order."""
    m, nn = x.shape
    shards = x.view(m, q, nn // q).permute(1, 0, 2)[None]  # (1, q, m, kloc)
    g = all_gather_a(shards, COL_AXIS, q, axis=2)  # (1, 1, m, kloc, q)
    return g[0, 0].movedim(2, 1).reshape(m, nn)


def _stedc_dist_levels(dp: torch.Tensor, ep: torch.Tensor, p: int, q: int, N: int):
    """The sharded level loop.  Returns (w (N,), Z (N, N)) with Z's rows in
    the stacked (interleaved) order, mesh row r holding rows
    [r N/p, (r + 1) N/p)."""
    S = _DC_SMALL
    dtype, dev = dp.dtype, dp.device
    nblk = N // S
    # replicated base solves
    db = dp.reshape(nblk, S)
    eb = torch.cat([ep, torch.zeros(1, dtype=dtype, device=dev)]).reshape(nblk, S)[:, :S - 1]
    w, qb = steqr(db, eb)
    rows_per = S // p
    q_loc = qb.reshape(nblk, p, rows_per, S).transpose(0, 1)  # (p, nblk, rows_per, S)
    s = S
    while s < N:
        m = N // (2 * s)
        rho = ep[(2 * torch.arange(m, device=dev) + 1) * s - 1]
        dd = w.reshape(m, 2 * s)
        qp = q_loc.reshape(p, m, 2, rows_per, s)
        # boundary rows -> replicated z: rooted broadcasts from the static
        # owner rows
        bot = bcast_from_row(qp[:, None, :, 0, -1, :], p - 1, p)[0, 0]
        top = bcast_from_row(qp[:, None, :, 1, 0, :], 0, p)[0, 0]
        z = torch.cat([bot, top], dim=1)  # (m, 2s)
        order = torch.argsort(dd, dim=1, stable=True)
        dd_s = torch.gather(dd, 1, order)
        z_s = torch.gather(z, 1, order)
        zf, cs_a, sn_a, active = _deflate_z(dd_s, z_s, rho)

        # the column shards' roots, all at once, gathered along the columns
        kidx = torch.arange(2 * s, device=dev)
        mu_k, aidx_k = _secular_roots_shard(dd_s, zf, rho, active, kidx)
        mu_all = _col_allgather(mu_k, q)
        # the anchor indices travel as int64, slate_tpu's index dtype under
        # jax_enable_x64 (int32 without it)
        aidx_all = _col_allgather(aidx_k, q)
        lam_anch_d = torch.gather(dd_s, 1, aidx_all)
        lam = lam_anch_d + mu_all
        zhat = _col_allgather(_zhat_shard(dd_s, zf, rho, active, lam_anch_d, mu_all, kidx), q)

        # eigenvector columns (m, 2s, 2s): every column shard's roots
        tiny = torch.finfo(dtype).tiny
        den = (dd_s[:, :, None] - lam_anch_d[:, None, :]) - mu_all[:, None, :]
        den = torch.where(den == 0, tiny, den)
        v = zhat[:, :, None] / den
        v = torch.where(active[:, None, :], v, 0.0)
        nrm = torch.sqrt((v * v).sum(dim=1))
        v = v / torch.where(nrm == 0, 1.0, nrm)[:, None, :]
        # deflated roots keep their (rotated) basis vector e_k
        ek = torch.eye(2 * s, dtype=dtype, device=dev)[None]
        v = v + torch.where(active[:, None, :], 0.0, 1.0) * ek
        v = _undo_deflation_rows(v, cs_a, sn_a)
        inv = torch.argsort(order, dim=1, stable=True)
        v = torch.gather(v, 1, inv[:, :, None].expand(v.shape))  # child row order

        # block-diagonal assembly on my rows x every column shard, then the
        # column all_gather restoring full columns
        qn = torch.cat([matmul(qp[:, :, 0], v[None, :, :s, :]),
                        matmul(qp[:, :, 1], v[None, :, s:, :])], dim=2)  # (p, m, 2 rows, 2s)
        kloc = (2 * s) // q
        shards = qn.view(p, m, 2 * rows_per, q, kloc).permute(0, 3, 1, 2, 4)  # (p, q, m, 2rp, kloc)
        g = all_gather_a(shards, COL_AXIS, q, axis=3)  # (p, 1, m, 2rp, kloc, q)
        q_loc = g[:, 0].movedim(4, 3).reshape(p, m, 2 * rows_per, 2 * s)
        w = lam.reshape(-1)
        rows_per *= 2
        s *= 2
    return w, q_loc.reshape(N, N)


def _stedc_finale(z: torch.Tensor, inv: torch.Tensor, order: torch.Tensor, p: int, q: int,
                  n: int) -> torch.Tensor:
    """Reshard the merge tree's row-sharded Z into ``chase_apply_dist``'s
    column-shard layout, applying the row un-interleave ``inv`` and the
    eigen-sort ``order`` on the way: device (r, c) takes its mesh column's
    output columns out of its row shard (the p strided npc-blocks
    (r' q + c) npc), all_gathers them along the rows and keeps its own
    block, rows permuted.  Output column block r q + c is device (r, c)'s."""
    N = z.shape[0]
    dev = z.device
    nparts = p * q
    npc = -(-n // nparts)  # output columns per device
    c_ = torch.arange(q, device=dev)
    colsq = ((torch.arange(p, device=dev)[None, :] * q + c_[:, None])[:, :, None] * npc
             + torch.arange(npc, device=dev)[None, None, :]).reshape(q, p * npc)
    srcq = order[colsq.clamp(max=n - 1)]  # (q, npq) eigen-order source columns
    z_loc = z.view(p, N // p, N)
    zc = torch.stack([z_loc[:, :, srcq[c]] for c in range(q)], dim=1)  # (p, q, N/p, npq)
    full = all_gather_a(zc, ROW_AXIS, p, axis=0)[0]  # (q, p, N/p, npq)
    full = full.reshape(q, N, p, npc)  # column block r' of mesh column c
    sub = full[:, inv[:n]]  # (q, n, p, npc): rows un-interleaved
    out = sub.permute(1, 2, 0, 3).reshape(n, nparts * npc)  # block r q + c
    cols = torch.arange(nparts * npc, device=dev)
    return torch.where((cols < n)[None, :], out, 0)[:, :n]
