"""Batched small-problem drivers and block-diagonal ragged packing.

Counterpart of ``slate_tpu/serve/batch.py``.  The serving workload is a
flood of same-shaped small solves.  ``slate_tpu`` runs a stack of B problems
as one compiled program that maps the single-problem verbs with
``lax.map``, so each row is bitwise its single solve (it rejects ``vmap``,
whose batched reductions break that).  The port's form is a loop over its
own single verbs (``linalg.chol.posv_array``, ``linalg.lu.gesv_array``,
``blas3.gemm_array``) into preallocated output stacks: each row is bitwise
the single verb on that problem.  No batched ``torch.linalg`` call stands in
for the loop, since it would break the same contract.

The mesh path batches by packing: ``pack_block_diag`` bins ragged sizes
into a few canonical shapes (identity-padded to the bin) and packs k
problems into one block-diagonal operand, one mesh factorization factors
all k, and ``unpack_block_diag`` recovers each solution.  Co-packed blocks
meet only through products with exact zeros, so each unpacked solution is
bitwise what the same problem gives packed alone, also where a tile of the
mesh straddles two problems.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..types import MethodLU, Options, Uplo
from .metrics import serve_count

# The canonical serving bins: a request of size n runs at the smallest bin
# >= n.  The bin set is the cache key vocabulary.
DEFAULT_BINS: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096)


def record_batch_size(op: str, count: int) -> None:
    """Observe one dispatched batch's size into the ``serve.batch_size``
    histogram (no-op while the obs layer is off)."""
    from ..obs import REGISTRY, enabled

    if enabled():
        REGISTRY.observe("serve.batch_size", float(count), op=op)


# ---------------------------------------------------------------------------
# Stacked batch drivers (each row bitwise its single verb)
# ---------------------------------------------------------------------------


def solve_rows(one, a: torch.Tensor, b: torch.Tensor):
    """The stacked program over a single-problem solve ``one(a_i, b_i) ->
    (x_i, info_i)``: a loop into preallocated (B, n, nrhs) / (B,) int32
    stacks, so each row is bitwise ``one`` on its problem."""
    x = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    info = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    for i in range(a.shape[0]):
        x[i], info[i] = one(a[i], b[i])
    return x, info


def _posv_one(a: torch.Tensor, b: torch.Tensor):
    from ..linalg.chol import posv_array

    x, _f, info = posv_array(a, b, Uplo.Lower)
    return x, info


def posv_batched(a: torch.Tensor, b: torch.Tensor):
    """Stacked SPD solve: ``a`` (B, n, n) lower-referenced, ``b``
    (B, n, nrhs).  Returns (x (B, n, nrhs), info (B,)); row i is bitwise
    ``chol.posv_array(a[i], b[i])``."""
    return solve_rows(_posv_one, a, b)


def potrf_batched(a: torch.Tensor):
    """Stacked lower Cholesky: (B, n, n) -> (l (B, n, n), info (B,))."""
    from ..linalg.chol import potrf_array

    l = torch.empty_like(a)
    info = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    for i in range(a.shape[0]):
        l[i], info[i] = potrf_array(a[i], Uplo.Lower)
    return l, info


def gesv_batched(a: torch.Tensor, b: torch.Tensor, method: MethodLU = MethodLU.PartialPiv):
    """Stacked general solve: (x (B, n, nrhs), info (B,)); row i is bitwise
    ``lu.gesv_array(a[i], b[i], method)``."""
    from ..linalg.lu import gesv_array

    def one(ai, bi):
        x, f = gesv_array(ai, bi, method)
        return x, f.info

    return solve_rows(one, a, b)


def gemm_batched(alpha, a: torch.Tensor, b: torch.Tensor, beta=0.0,
                 c: Optional[torch.Tensor] = None):
    """Stacked C = alpha A B + beta C over (B, m, k) x (B, k, n)."""
    from ..blas3.blas3 import gemm_array

    if c is None:
        c = torch.zeros(a.shape[:2] + (b.shape[2],), dtype=a.dtype, device=a.device)
    out = torch.empty_like(c)
    for i in range(a.shape[0]):
        out[i] = gemm_array(alpha, a[i], b[i], beta, c[i])
    return out


BATCHED_DRIVERS = {
    "posv": posv_batched,
    "gesv": gesv_batched,
    "potrf": potrf_batched,
    "gemm": gemm_batched,
}


# ---------------------------------------------------------------------------
# Ragged-size binning and block-diagonal packing
# ---------------------------------------------------------------------------


def bin_for(n: int, bins: Sequence[int] = DEFAULT_BINS) -> Optional[int]:
    """Smallest canonical bin >= n, or None when n exceeds every bin."""
    for m in sorted(bins):
        if n <= m:
            return int(m)
    return None


def pad_to_bin(a: torch.Tensor, m: int, factorizable: bool = True) -> torch.Tensor:
    """Pad an (n, n) operand to (m, m): ``factorizable`` puts the identity on
    the new diagonal (diag(A, I) factors to diag(L, I), the pad never mixing
    into data rows), else zeros.  An operand already at the bin is returned
    as it is."""
    a = torch.as_tensor(a)
    n = a.shape[0]
    if n == m:
        return a
    if n > m:
        raise ValueError(f"operand of size {n} exceeds bin {m}")
    out = torch.zeros((m, m), dtype=a.dtype, device=a.device)
    out[:n, :n] = a
    if factorizable:
        out.diagonal()[n:] = 1
    return out


def pad_rhs_to_bin(b: torch.Tensor, m: int) -> torch.Tensor:
    """Zero-pad an (n, nrhs) right-hand side to (m, nrhs)."""
    b = torch.as_tensor(b)
    n = b.shape[0]
    if n == m:
        return b
    out = torch.zeros((m,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
    out[:n] = b
    return out


def pack_block_diag(operands: Sequence[torch.Tensor], m: int,
                    rhs: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pack k ragged operands (each n_i <= m) into ONE (k m, k m)
    block-diagonal matrix (each block identity-padded to the bin) and, when
    given, their right-hand sides into one (k m, nrhs) stack.  Counts
    ``packed_problems``."""
    ops = [torch.as_tensor(op) for op in operands]
    k = len(ops)
    a = torch.zeros((k * m, k * m), dtype=ops[0].dtype, device=ops[0].device)
    for i, op in enumerate(ops):
        a[i * m:(i + 1) * m, i * m:(i + 1) * m] = pad_to_bin(op, m)
    serve_count("packed_problems", k)
    if rhs is None:
        return a, None
    rs = [torch.as_tensor(r) for r in rhs]
    nrhs = max(r.shape[1] for r in rs)
    b = torch.zeros((k * m, nrhs), dtype=a.dtype, device=a.device)
    for i, r in enumerate(rs):
        b[i * m:i * m + r.shape[0], :r.shape[1]] = r
    return a, b


def unpack_block_diag(x: torch.Tensor, sizes: Sequence[int], m: int,
                      nrhs: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Slice each problem's solution out of a packed solve's (k m, nrhs)
    stack: block i's rows are [i m, i m + sizes[i])."""
    out = []
    for i, n in enumerate(sizes):
        xi = x[i * m:i * m + n]
        if nrhs is not None:
            xi = xi[:, :nrhs[i]]
        out.append(xi)
    return out


def posv_packed_mesh(operands: Sequence[torch.Tensor], rhs: Sequence[torch.Tensor], mesh,
                     nb: Optional[int] = None, bins: Sequence[int] = DEFAULT_BINS,
                     opts: Optional[Options] = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Ragged SPD solves through ONE mesh factorization: bin to the largest
    requested size, pack block-diagonally on ``mesh.device``, run
    ``posv_mesh`` once, unpack.  Unset schedule options resolve through the
    tuned table (explicit > context > env > tuned > auto): the tuned ``nb``
    is the tile size when ``nb`` is None, and a tuned BcastImpl / Lookahead
    rides ``opts`` into the mesh k-loops.  Returns (solutions, info)."""
    from ..parallel.drivers import posv_mesh
    from ..parallel.mesh import mesh_shape
    from ..types import Option, get_option
    from .cache import dtype_name
    from .table import resolve_request_options

    ops = [torch.as_tensor(op, device=mesh.device) for op in operands]
    rs = [torch.as_tensor(r, device=mesh.device) for r in rhs]
    m = bin_for(max(op.shape[0] for op in ops), bins)
    if m is None:
        raise ValueError("packed operand exceeds the largest serving bin")
    record_batch_size("posv_packed", len(ops))
    a, b = pack_block_diag(ops, m, rs)
    merged = resolve_request_options(opts, "posv", a.shape[0], dtype_name(a), mesh_shape(mesh))
    if nb is None:
        nb = int(get_option(merged, Option.BlockSize, default=64))
    x, info = posv_mesh(a, b, mesh, nb, merged)
    return unpack_block_diag(x, [op.shape[0] for op in ops], m, [r.shape[1] for r in rs]), info
