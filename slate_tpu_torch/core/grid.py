"""Distribution functions: block sizes and the tile -> process / device maps.

Counterpart of ``slate_tpu/core/grid.py`` (the reference's func.hh): plain
Python callables used when building block-cyclic layouts, with the
reference's arithmetic.  The device maps define which virtual device holds
which block (``parallel.mesh.make_mesh``), the identity that
``parallel.dist.redistribute`` reads.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

from ..types import GridOrder


def uniform_blocksize(n: int, nb: int) -> Callable[[int], int]:
    """Block-size lambda: all tiles nb except a possibly short last one."""

    nt = num_tiles(n, nb)

    def f(i: int) -> int:
        return nb if i < nt - 1 else n - (nt - 1) * nb

    return f


def num_tiles(n: int, nb: int) -> int:
    return max(1, -(-n // nb)) if n > 0 else 0


def process_2d_grid(order: GridOrder, p: int, q: int) -> Callable[[Tuple[int, int]], int]:
    """2D block-cyclic tile -> rank map (func.hh:154): rank of tile (i, j)."""

    def f(ij: Tuple[int, int]) -> int:
        i, j = ij
        if order == GridOrder.Col:
            return int(i % p + (j % q) * p)
        return int((i % p) * q + j % q)

    return f


def process_1d_grid(order: GridOrder, size: int) -> Callable[[Tuple[int, int]], int]:
    """1D block-cyclic map (func.hh:181)."""
    if order == GridOrder.Col:
        return process_2d_grid(GridOrder.Col, size, 1)
    return process_2d_grid(GridOrder.Row, 1, size)


def device_2d_grid(order: GridOrder, p: int, q: int) -> Callable[[Tuple[int, int]], int]:
    """Tile -> device map (func.hh:78).  One process is one device, so it
    coincides with process_2d_grid."""
    return process_2d_grid(order, p, q)


def device_1d_grid(order: GridOrder, size: int) -> Callable[[Tuple[int, int]], int]:
    return process_1d_grid(order, size)


def transpose_grid(f: Callable[[Tuple[int, int]], int]) -> Callable[[Tuple[int, int]], int]:
    """Map for the transposed matrix (func.hh:203)."""

    def g(ij: Tuple[int, int]) -> int:
        i, j = ij
        return f((j, i))

    return g


def grid_2d_factor(nranks: int) -> Tuple[int, int]:
    """The near-square p x q = nranks grid (the testers' grid helper,
    test/grid_utils.hh)."""
    p = int(math.isqrt(nranks))
    while nranks % p != 0:
        p -= 1
    return p, nranks // p
