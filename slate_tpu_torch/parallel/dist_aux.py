"""Distributed matrix norms on the virtual mesh.

Counterpart of ``norm_dist`` in ``slate_tpu/parallel/dist_aux.py`` (the
reference's ``src/norm.cc``: local tile reductions, then an all-reduce).
Every device reduces its local tiles, masked to the true (m, n) extent so
pad tiles and the identity-padded diagonal never count, then the partial
sums travel through the audited ``psum_a`` and the maxima through ``pmax``,
in ``slate_tpu``'s order.  The condition estimators and the distributed
inverses of ``dist_aux`` come with a later slice.
"""

from __future__ import annotations

import torch

from ..types import Norm
from .comm import COL_AXIS, ROW_AXIS, local_indices, pmax, psum_a
from .dist import DistMatrix, local_view
from .mesh import mesh_shape


def masked_abs(t_loc: torch.Tensor, p: int, q: int, m_true: int, n_true: int) -> torch.Tensor:
    """|t| of a local view (p, q, ..., mtl, ntl, nb, nb), zero outside the
    true (m, n) extent (any dims between the grid and the tile grid are
    batch dims)."""
    mtl, ntl, nb = t_loc.shape[-4], t_loc.shape[-3], t_loc.shape[-1]
    _r, _c, i_log, j_log = local_indices(p, q, mtl, ntl, device=t_loc.device)
    ar = torch.arange(nb, device=t_loc.device)
    gr = (i_log * nb)[..., :, None, None, None] + ar[:, None]  # (p, 1, mtl, 1, nb, 1)
    gc = (j_log * nb)[..., None, :, None, None] + ar  # (1, q, 1, ntl, 1, nb)
    mask = (gr < m_true) & (gc < n_true)
    batch = t_loc.dim() - 6
    mask = mask.view(mask.shape[:2] + (1,) * batch + mask.shape[2:])
    return torch.where(mask, t_loc.abs(), torch.zeros((), dtype=t_loc.real.dtype,
                                                      device=t_loc.device))


def norm_dist(norm: Norm, d: DistMatrix) -> torch.Tensor:
    """One / Inf / Max / Fro norm of a DistMatrix, computed distributed: a
    0-d tensor of the real dtype."""
    p, q = mesh_shape(d.mesh)
    absa = masked_abs(local_view(d.tiles, p, q), p, q, d.m, d.n)  # (p, q, mtl, ntl, nb, nb)

    def allred_max(x):
        return pmax(pmax(x, ROW_AXIS, p), COL_AXIS, q)

    if norm == Norm.Max:
        out = allred_max(absa.amax(dim=(2, 3, 4, 5)))
    elif norm == Norm.Fro:
        # lassq-style: divide by the global max before squaring
        amax = allred_max(absa.amax(dim=(2, 3, 4, 5)))  # (1, 1)
        scale = torch.where(amax > 0, amax, torch.ones_like(amax))
        ssq = ((absa / scale[..., None, None, None, None]) ** 2).sum(dim=(2, 3, 4, 5))
        ssq = psum_a(psum_a(ssq, ROW_AXIS, p), COL_AXIS, q)
        out = scale * torch.sqrt(ssq)
    elif norm == Norm.One:
        colsums = psum_a(absa.sum(dim=(2, 4)), ROW_AXIS, p)  # (1, q, ntl, nb)
        out = pmax(pmax(colsums.amax(dim=(2, 3)), COL_AXIS, q), ROW_AXIS, p)
    elif norm == Norm.Inf:
        rowsums = psum_a(absa.sum(dim=(3, 5)), COL_AXIS, q)  # (p, 1, mtl, nb)
        out = allred_max(rowsums.amax(dim=(2, 3)))
    else:
        raise ValueError(norm)
    return out[0, 0]
