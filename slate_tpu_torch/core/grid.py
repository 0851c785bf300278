"""Distribution functions: block sizes and the tile -> process map.

Counterpart of ``slate_tpu/core/grid.py`` (the reference's func.hh): plain
Python callables used when building block-cyclic layouts.  Only the helpers
the mesh slice reads are here, with the reference's arithmetic.
"""

from __future__ import annotations

from typing import Callable


def uniform_blocksize(n: int, nb: int) -> Callable[[int], int]:
    """Block-size lambda: all tiles nb except a possibly short last one."""

    nt = num_tiles(n, nb)

    def f(i: int) -> int:
        return nb if i < nt - 1 else n - (nt - 1) * nb

    return f


def num_tiles(n: int, nb: int) -> int:
    return max(1, -(-n // nb)) if n > 0 else 0
