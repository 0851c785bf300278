"""Tile-stack packing and block-cyclic layout transforms.

Counterpart of ``slate_tpu/core/tiling.py``.  A matrix is held as a *tile
stack* of shape ``(mt, nt, nb, nb)`` (short edge tiles zero-padded), and the
2D block-cyclic distribution over a (p, q) grid is a permutation of tile
indices: tile row ``i`` sits at storage slot ``(i % p) * (mt / p) + i // p``,
so that cutting the stack into p x q contiguous blocks gives every grid
position exactly its cyclic tiles.  The index maps are bitwise the
reference's (numpy, the same ``argsort``).

Where the tile counts are multiples of (p, q) -- every ``DistMatrix`` --
:func:`to_cyclic` / :func:`from_cyclic` take a single copy: the dense
matrix viewed as ``(mtl, p, nb, ntl, q, nb)`` permuted to
``(p, mtl, q, ntl, nb, nb)`` *is* the cyclic stack.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .grid import num_tiles


def pad_to_tiles(a: torch.Tensor, nb: int) -> torch.Tensor:
    """Zero-pad (m, n) up to multiples of nb (``a`` itself when no pad)."""
    m, n = a.shape
    mp = num_tiles(m, nb) * nb
    np_ = num_tiles(n, nb) * nb
    if mp == m and np_ == n:
        return a
    return torch.nn.functional.pad(a, (0, np_ - n, 0, mp - m))


def to_tiles(a: torch.Tensor, nb: int) -> torch.Tensor:
    """Dense (m, n) -> tile stack (mt, nt, nb, nb), a view where no pad is
    needed; pads short edges."""
    a = pad_to_tiles(a, nb)
    m, n = a.shape
    mt, nt = m // nb, n // nb
    return a.reshape(mt, nb, nt, nb).permute(0, 2, 1, 3)


def from_tiles(t: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Tile stack (mt, nt, nb, nb) -> dense (m, n), dropping pad."""
    mt, nt, nb, _ = t.shape
    a = t.permute(0, 2, 1, 3).reshape(mt * nb, nt * nb)
    return a[:m, :n]


def cyclic_perm(mt: int, p: int) -> np.ndarray:
    """Permutation sending logical tile index i to storage slot so that a
    contiguous p-way split of storage = cyclic distribution of logical
    tiles: ``storage[s] = logical[perm[s]]``."""
    i = np.arange(mt, dtype=np.int64)
    return np.argsort((i % p) * mt + i // p, kind="stable").astype(np.int32)


def inv_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def _perm_index(perm: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(perm.astype(np.int64)).to(device)


def to_cyclic(t: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """Reorder a tile stack into 2D block-cyclic storage order (a new
    tensor).  With (mt, nt) multiples of (p, q) this is one permuted copy;
    otherwise it gathers through :func:`cyclic_perm`."""
    mt, nt, nb, nb2 = t.shape
    if mt % p == 0 and nt % q == 0:
        return (t.reshape(mt // p, p, nt // q, q, nb, nb2)
                .permute(1, 0, 3, 2, 4, 5).reshape(mt, nt, nb, nb2))
    rp = _perm_index(cyclic_perm(mt, p), t.device)
    cp = _perm_index(cyclic_perm(nt, q), t.device)
    return t[rp][:, cp]


def from_cyclic(t: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """Inverse of :func:`to_cyclic` (a new tensor)."""
    mt, nt, nb, nb2 = t.shape
    if mt % p == 0 and nt % q == 0:
        return (t.reshape(p, mt // p, q, nt // q, nb, nb2)
                .permute(1, 0, 3, 2, 4, 5).reshape(mt, nt, nb, nb2))
    rp = _perm_index(inv_perm(cyclic_perm(mt, p)), t.device)
    cp = _perm_index(inv_perm(cyclic_perm(nt, q)), t.device)
    return t[rp][:, cp]


def tile_shape(m: int, n: int, nb: int) -> Tuple[int, int]:
    return num_tiles(m, nb), num_tiles(n, nb)
