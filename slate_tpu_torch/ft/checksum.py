"""Tile-level ABFT checksums over the block-cyclic layout.

Counterpart of ``slate_tpu/ft/checksum.py``.  The Huang & Abraham (1984)
scheme at nb-tile granularity: a matrix padded to its (mt, nt) tile grid
gains TWO checksum tile rows,

    CS1[:, j] = sum_i  T(i, j)            (unit weights)
    CS2[:, j] = sum_i (i + 1) T(i, j)     (ramp weights)

(and symmetrically two checksum tile columns).  Both are linear in the
rows, so BLAS-3 tile algebra maintains them: GEMM maps them to the
checksums of C, a right-looking factorization forward-substitutes them
into the checksums of the output factor (Du, Bosilca & Dongarra, PPoPP
2012).  The checksum tiles are ordinary tiles appended to the grid.

Verification recomputes the tile sums of the output and differences them
against the carried checksum tiles.  A single corrupted tile row leaves
per-column discrepancies D1[j] = -E(i*, j), D2[j] = -(i* + 1) E(i*, j):
the ratio D2/D1 LOCATES the row i*, and adding D1[j] back restores the
data exactly — including the clean run's rounding, since D1 carries it.

The encode and residual half works on torch tensors on their device (the
card for a card-sized matrix); the thresholding and location half is
plain numpy on the few small blocks the verify brings to the host.
"""

from __future__ import annotations

import numpy as np
import torch

# detection threshold: a tile-column discrepancy is a FAULT when its
# magnitude exceeds TOL_FACTOR * n_ops * eps * column_scale.  The clean
# residual of a sum of k products is O(sqrt(k) * eps * scale); the factor
# leaves ~3 orders of margin to the faults worth injecting while keeping
# clean f32 runs quiet.
TOL_FACTOR = 64.0


def pad_dense(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``a`` zero-padded to (rows, cols); ``a`` itself when no pad is
    needed (callers never write into the result)."""
    m, n = a.shape
    if (m, n) == (rows, cols):
        return a
    return torch.nn.functional.pad(a, (0, cols - n, 0, rows - m))


def _ramp(k: int, ap: torch.Tensor) -> torch.Tensor:
    """The weights 1..k in ``ap``'s dtype, made in its real dtype (torch
    has no complex arange) and cast."""
    return torch.arange(1, k + 1, dtype=ap.real.dtype, device=ap.device).to(ap.dtype)


def row_checksums(ap: torch.Tensor, nb: int) -> torch.Tensor:
    """(mt*nb, N) -> (2*nb, N): unit-sum tile row stacked on ramp-sum."""
    mt = ap.shape[0] // nb
    t = ap.reshape(mt, nb, ap.shape[1])
    w = _ramp(mt, ap)
    return torch.cat([t.sum(0), (w[:, None, None] * t).sum(0)], dim=0)


def col_checksums(ap: torch.Tensor, nb: int) -> torch.Tensor:
    """(M, nt*nb) -> (M, 2*nb): unit and ramp tile-column sums."""
    nt = ap.shape[1] // nb
    t = ap.reshape(ap.shape[0], nt, nb)
    w = _ramp(nt, ap)
    return torch.cat([t.sum(1), (w[None, :, None] * t).sum(1)], dim=1)


def ratio_locate(d1_blk: np.ndarray, d2_blk: np.ndarray, axis_len: int) -> int:
    """Row (resp. column) index from the ramp/unit discrepancy ratio of
    one tile block: uses the element of largest |d1| for a well-scaled
    quotient.  Returns -1 when the ratio is not a consistent integer in
    range — the can't-locate signal."""
    if not (np.isfinite(d1_blk).all() and np.isfinite(d2_blk).all()):
        return -1  # NaN/Inf-poisoned: detectable, never locatable
    flat = np.abs(d1_blk).ravel()
    if flat.max() == 0:
        return -1
    at = int(flat.argmax())
    ratio = d2_blk.ravel()[at] / d1_blk.ravel()[at]
    if not np.isfinite(ratio):
        return -1
    idx = int(np.rint(ratio)) - 1
    if not (0 <= idx < axis_len) or abs(ratio - np.rint(ratio)) > 0.25:
        return -1
    return idx


def threshold(nt_ops: int, dtype, scale: float) -> float:
    eps = float(torch.finfo(dtype).eps)
    return TOL_FACTOR * max(nt_ops, 1) * eps * max(scale, 1.0)


def flag_mismatches(d: np.ndarray, tol: float) -> np.ndarray:
    """Indices where the per-tile discrepancy exceeds the threshold.
    Non-finite discrepancies are faults by definition (a NaN-poisoned
    factor must not read as clean because NaN compares false)."""
    d = np.asarray(d)
    return np.nonzero((d > tol) | ~np.isfinite(d))[0]


def finite_max(a) -> float:
    """Max-abs with non-finite entries treated as 1 — keeps detection
    thresholds finite on poisoned data (the poison itself is flagged by
    ``flag_mismatches``).  Takes a tensor (reduced on its device) or a
    numpy array."""
    if isinstance(a, torch.Tensor):
        if a.numel() == 0:
            raise ValueError("finite_max of an empty tensor")
        return float(torch.nan_to_num(a.abs(), nan=1.0, posinf=1.0, neginf=1.0).max())
    return float(np.nan_to_num(np.abs(a), nan=1.0, posinf=1.0, neginf=1.0).max())
