"""Core enums, options and errors of the PyTorch port.

Counterpart of ``slate_tpu/types.py``: the same enum classes with the same
member names and values, so that a test can map one package's enum onto the
other's by name (``utils.testing.options_from_names``).  Only the enums the
ported paths read are here (the single-chip Cholesky path and the mesh
solve: grid order, MethodGemm/MethodTrsm and their selectors; the mesh
BLAS-3: MethodHemm and its selector; the mesh LU
solves: MethodLU; least squares: MethodGels; the norms and condition
estimators: Norm, NormScope); the other method enums come with the slices
that read them.
"""

from __future__ import annotations

import enum
from typing import Any, Mapping, Optional, Union


class Uplo(enum.Enum):
    """Which triangle of a matrix is stored/referenced."""

    Upper = "U"
    Lower = "L"
    General = "G"


class Op(enum.Enum):
    """Logical transposition applied to a matrix view."""

    NoTrans = "N"
    Trans = "T"
    ConjTrans = "C"


class Diag(enum.Enum):
    Unit = "U"
    NonUnit = "N"


class Side(enum.Enum):
    Left = "L"
    Right = "R"


class Norm(enum.Enum):
    """Matrix norms (LAPACK convention)."""

    One = "1"
    Inf = "I"
    Max = "M"
    Fro = "F"


class NormScope(enum.Enum):
    """Whole-matrix norm vs per-row / per-column norms."""

    Matrix = "M"
    Columns = "C"
    Rows = "R"


class Target(enum.Enum):
    """Execution target.  ``TPU`` keeps its name so that options map across
    packages by name; in this package it means the accelerator (a CUDA
    card), ``Host`` the CPU."""

    TPU = "tpu"
    Host = "host"


class GridOrder(enum.Enum):
    """Process-grid ordering for 2D block-cyclic distributions."""

    Col = "C"
    Row = "R"


class MethodGemm(enum.Enum):
    Auto = "auto"
    GemmA = "A"  # stationary-A
    GemmC = "C"  # stationary-C (SUMMA)


class MethodTrsm(enum.Enum):
    Auto = "auto"
    TrsmA = "A"
    TrsmB = "B"


class MethodHemm(enum.Enum):
    Auto = "auto"
    HemmA = "A"  # stationary-A (hemmA)
    HemmC = "C"  # the k-loop broadcast pipeline


class MethodGels(enum.Enum):
    QR = "QR"
    CholQR = "CholQR"


class MethodLU(enum.Enum):
    PartialPiv = "PPLU"
    CALU = "CALU"  # tournament pivoting (getrf_tntpiv analog)
    NoPiv = "NoPiv"
    RBT = "RBT"  # random butterfly transform + no-pivot LU


class MethodEig(enum.Enum):
    QR = "QR"  # steqr: tridiagonal QR iteration
    DC = "DC"  # stedc: divide and conquer


class MethodSVD(enum.Enum):
    QR = "QR"  # bdsqr
    DC = "DC"


def select_gemm_method(m: int, n: int, k: int) -> MethodGemm:
    """Tile-grid heuristic of ``slate_tpu``: a tiny output panel (n tile
    columns against m rows or k inner tiles) takes stationary-A."""
    if n <= max(m, k) // 4:
        return MethodGemm.GemmA
    return MethodGemm.GemmC


def select_trsm_method(side: "Side", m: int, n: int) -> MethodTrsm:
    """Solve-side-dominant shapes (B far thinner than A) take TrsmA."""
    if (side == Side.Left and n <= m // 4) or (side == Side.Right and m <= n // 4):
        return MethodTrsm.TrsmA
    return MethodTrsm.TrsmB


def select_hemm_method(m: int, n: int) -> MethodHemm:
    """``slate_tpu``'s rule in tiles: a B/C panel of n tile columns against
    an A of m tile rows takes stationary-A when n <= m / 4 (the reference
    switches on n < 2 nb; callers pinning that pass Option.MethodHemm)."""
    if n <= m // 4:
        return MethodHemm.HemmA
    return MethodHemm.HemmC


class Precision(enum.Enum):
    """Accumulation-precision tier for BLAS-3 (Option.Precision).

    On the card (ops/matmul.py): ``Fast`` is bf16 inputs with f32
    accumulation, ``High`` is TF32, ``Highest`` and ``Emulated`` are full
    f32/f64 (never TF32).  Every driver defaults to Highest."""

    Fast = "fast"
    High = "high"
    Highest = "highest"
    Emulated = "emulated"


class Option(enum.Enum):
    """Driver options; the same members and values as ``slate_tpu``'s, whose
    comments document each one.  The mesh drivers (``parallel/``) read
    Lookahead (default 1, below), BcastImpl and UpdateImpl (both resolve to
    ``auto`` when unset: ``parallel.comm.resolve_bcast_impl``,
    ``ops.kernels.resolve_update_impl``); the serving options are accepted
    and ignored until the slices that read them are ported."""

    ChunkSize = "chunk_size"
    Lookahead = "lookahead"
    BlockSize = "block_size"
    InnerBlocking = "inner_blocking"
    MaxPanelThreads = "max_panel_threads"
    Tolerance = "tolerance"
    Target = "target"
    MaxIterations = "max_iterations"
    UseFallbackSolver = "use_fallback_solver"
    PivotThreshold = "pivot_threshold"
    MethodCholQR = "method_cholqr"
    MethodEig = "method_eig"
    MethodGels = "method_gels"
    MethodGemm = "method_gemm"
    MethodHemm = "method_hemm"
    MethodLU = "method_lu"
    MethodTrsm = "method_trsm"
    MethodSVD = "method_svd"
    PrintVerbose = "print_verbose"
    PrintPrecision = "print_precision"
    Depth = "depth"
    Precision = "precision"
    FaultTolerance = "fault_tolerance"
    BcastImpl = "bcast_impl"
    # diagonal-block factor lowering (ops/kernels.py): "xla" (the
    # torch.linalg cholesky + solve_triangular pair), "pallas" (the
    # hand-written CUDA kernel on a CUDA tensor, its plain twin on a CPU
    # tensor) or "auto" (the default: same as "pallas").  The value names
    # are slate_tpu's.  Resolution order: explicit > ops.kernels.
    # use_panel_impl context > SLATE_TPU_PANEL_IMPL environment > auto.
    PanelImpl = "panel_impl"
    UpdateImpl = "update_impl"
    MixedPrecision = "mixed_precision"
    NumMonitor = "num_monitor"
    AutoTune = "auto_tune"
    Checkpoint = "checkpoint"
    ResidualImpl = "residual_impl"


Options = Mapping[Union[Option, str], Any]

_DEFAULTS = {
    Option.Lookahead: 1,
    Option.BlockSize: 256,
    Option.InnerBlocking: 32,
    Option.Tolerance: None,
    Option.Target: Target.TPU,
    Option.MaxIterations: 30,
    Option.UseFallbackSolver: True,
    Option.PivotThreshold: 1.0,
    Option.Depth: 2,
}


def get_option(opts: Optional[Options], key: Option, default: Any = None) -> Any:
    """Typed option lookup: by enum member, then by its string value."""
    if opts:
        if key in opts:
            return opts[key]
        if key.value in opts:
            return opts[key.value]
    if default is not None:
        return default
    return _DEFAULTS.get(key)


class SlateError(Exception):
    """slate::Exception analog."""
