"""Random Butterfly Transform LU (gesv_rbt).

Counterpart of ``slate_tpu/linalg/rbt.py`` (the reference's
``src/gesv_rbt.cc``, ``src/gerbt.cc``, ``internal_gerbt.cc`` and
``internal_rbt_generate.cc``): multiply A by depth-d random butterflies on
both sides so that pivoting becomes unnecessary with high probability,
factor with the no-pivot LU, and clean up with one step of iterative
refinement.  A depth-1 butterfly is B = (1/sqrt 2) [[R0, R1], [R0, -R1]]
with random diagonals R0, R1; depth d applies independent butterflies to
nested halves.  A x = b is solved as x = V (U^T A V)^-1 U^T b.

The random diagonals come from an explicit ``torch.Generator`` on the
operand's device (``generator=None`` seeds a fresh one per call, as the
reference draws fresh entropy).  The public entry points draw them and then
call :func:`_gerbt_apply` / :func:`_gesv_rbt_with`, which take the
diagonals; any diagonals of the right shape can be fed there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.matmul import matmul
from ..types import Option, Options, get_option
from .lu import LUFactors, getrf_nopiv_array, getrs_array

_SQRT1_2 = 0.7071067811865476


def _rand_diag(generator: torch.Generator, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """exp(r) with r uniform on [-0.05, 0.05] (internal_rbt_generate.cc):
    near-1 positive scalings, drawn in f64 unless the dtype is f32."""
    rdt = torch.float32 if dtype == torch.float32 else torch.float64
    r = torch.empty(n, dtype=rdt, device=device).uniform_(-0.05, 0.05, generator=generator)
    return torch.exp(r).to(dtype)


def generate_butterfly(generator: torch.Generator, n: int, depth: int, dtype: torch.dtype,
                       device=None) -> torch.Tensor:
    """Random diagonals packed as (depth, n); level l acts on blocks of size
    n / 2^l (n divisible by 2^depth; the drivers pad)."""
    return torch.stack([_rand_diag(generator, n, dtype, device) for _ in range(depth)])


def _apply_level(x: torch.Tensor, d: torch.Tensor, block: int, trans: bool) -> torch.Tensor:
    """One butterfly level on the rows of x: for each block pair (top, bot)
    of size block / 2, top' = r0 top + r1 bot and bot' = r0 top - r1 bot
    (times 1/sqrt 2); ``trans`` applies B^T, which moves the diagonals."""
    n = x.shape[0]
    h = block // 2
    xb = x.reshape(n // block, block, -1)
    r = d.reshape(n // block, block)
    r0, r1 = r[:, :h, None], r[:, h:, None]
    top, bot = xb[:, :h], xb[:, h:]
    if not trans:
        new_top = r0 * top + r1 * bot
        new_bot = r0 * top - r1 * bot
    else:
        new_top = r0 * (top + bot)
        new_bot = r1 * (top - bot)
    return (torch.cat([new_top, new_bot], dim=1) * _SQRT1_2).reshape(n, -1)


def apply_butterfly(x: torch.Tensor, diags: torch.Tensor, trans: bool) -> torch.Tensor:
    """x := W^(T) x for a depth-d butterfly W = L_0 L_1 ... (coarsest
    first): W x applies the finest level first, W^T x the coarsest."""
    n = x.shape[0]
    depth = diags.shape[0]
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    levels = range(depth) if trans else range(depth - 1, -1, -1)
    for lev in levels:
        x = _apply_level(x, diags[lev], n // (2 ** lev), trans)
    return x[:, 0] if squeeze else x


def _pad_pow2(n: int, depth: int) -> int:
    mult = 2 ** depth
    return ((n + mult - 1) // mult) * mult


def _draw(a: torch.Tensor, generator: Optional[torch.Generator], depth: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two butterflies' diagonals for A, (U's, V's), each (depth, npad)."""
    if generator is None:
        generator = torch.Generator(device=a.device)
        generator.seed()
    npad = _pad_pow2(a.shape[0], depth)
    ud = generate_butterfly(generator, npad, depth, a.dtype, a.device)
    vd = generate_butterfly(generator, npad, depth, a.dtype, a.device)
    return ud, vd


def _gerbt_apply(a: torch.Tensor, ud: torch.Tensor, vd: torch.Tensor) -> torch.Tensor:
    """U^T A V for the diagonals ``ud``, ``vd``, A padded with an identity
    block to their length."""
    n, npad = a.shape[0], ud.shape[1]
    if npad != n:
        a = torch.nn.functional.pad(a, (0, npad - n, 0, npad - n))
        fill = torch.arange(n, npad, device=a.device)
        a[fill, fill] = 1
    av = apply_butterfly(a.T, vd, trans=True).T  # A V = (V^T A^T)^T
    return apply_butterfly(av, ud, trans=True)  # U^T (A V)


def gerbt_array(a: torch.Tensor, generator: Optional[torch.Generator] = None, depth: int = 2
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Two-sided transform: (U^T A V, U's diagonals, V's diagonals, padded
    n).  A is padded with an identity block to a multiple of 2^depth.
    ``generator=None`` seeds a fresh generator per call: RBT's no-pivot
    safety is probabilistic, so a retry must see new butterflies."""
    ud, vd = _draw(a, generator, depth)
    return _gerbt_apply(a, ud, vd), ud, vd, ud.shape[1]


class RBTFactors(NamedTuple):
    """Reusable gesv_rbt factorization: the no-pivot LU of U^T A V with the
    butterflies, to solve against the ORIGINAL A (``getrs_array`` on
    ``lu_factors`` would solve with U^T A V)."""

    lu_factors: LUFactors  # LUFactors of U^T A V
    ud: torch.Tensor
    vd: torch.Tensor
    n: int
    npad: int

    @property
    def info(self):
        return self.lu_factors.info

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = V (U^T A V)^-1 U^T b for the original A."""
        squeeze = b.dim() == 1
        rhs = b[:, None] if squeeze else b
        rp = torch.nn.functional.pad(rhs, (0, 0, 0, self.npad - self.n))
        y = apply_butterfly(rp, self.ud, trans=True)  # U^T b
        z = getrs_array(self.lu_factors, y)
        x = apply_butterfly(z, self.vd, trans=False)[:self.n]  # V z
        return x[:, 0] if squeeze else x


def _gesv_rbt_with(a: torch.Tensor, b: torch.Tensor, ud: torch.Tensor, vd: torch.Tensor):
    """gesv_rbt with the given diagonals: transform, no-pivot LU, solve, one
    refinement step in working precision.  Returns (x, RBTFactors)."""
    squeeze = b.dim() == 1
    bd = b[:, None] if squeeze else b
    rf = RBTFactors(getrf_nopiv_array(_gerbt_apply(a, ud, vd)), ud, vd, a.shape[0], ud.shape[1])
    x = rf.solve(bd)
    r = bd - matmul(a, x).to(bd.dtype)
    x = x + rf.solve(r)
    return (x[:, 0] if squeeze else x), rf


def gesv_rbt_array(a: torch.Tensor, b: torch.Tensor, opts: Optional[Options] = None,
                   generator: Optional[torch.Generator] = None):
    """slate::gesv_rbt (src/gesv_rbt.cc), butterfly depth from Option.Depth
    (default 2).  Returns (x, RBTFactors); reuse the factors through
    ``RBTFactors.solve``, not ``getrs_array``."""
    depth = int(get_option(opts, Option.Depth, 2))
    ud, vd = _draw(a, generator, depth)
    return _gesv_rbt_with(a, b, ud, vd)
