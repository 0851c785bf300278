"""slate_tpu_torch — the PyTorch/CUDA port of slate_tpu.

A second package beside ``slate_tpu`` (the JAX reference, which this package
never imports).  Ported so far: the single-chip BLAS-3 verbs, the
Cholesky (with potri), LU (with getri, the norms and condition estimators
and mixed-precision refinement), QR, Hermitian eigen and SVD drivers, the
tile operations, the mesh solvers, BLAS-3, inverses, estimators, eigen and
SVD drivers on a virtual mesh, the ABFT
layer, and hand-written Hopper kernels for every Pallas kernel on those
paths (``ops/kernels.py``, ``csrc/*.cu``).  Entry points compute on the
tensors' device: pass CUDA tensors for the card, CPU tensors for the plain
twins; other operands go to the card unless ``device`` says otherwise.
"""

from .types import (
    Diag,
    MethodEig,
    MethodLU,
    MethodSVD,
    Norm,
    NormScope,
    Op,
    Option,
    Precision,
    Side,
    SlateError,
    Target,
    Uplo,
)
from .core import (
    BandMatrix,
    BaseMatrix,
    HermitianBandMatrix,
    HermitianMatrix,
    Matrix,
    SymmetricMatrix,
    TrapezoidMatrix,
    TriangularBandMatrix,
    TriangularMatrix,
)
from .blas3 import gbmm, gemm, hbmm, hemm, her2k, herk, symm, syr2k, syrk, trmm, trsm
from . import api, linalg, ops
from .linalg import (
    gecondest,
    gesv_array,
    gesv_mixed_array,
    getrf_array,
    getrs_array,
    heev_array,
    hegv_array,
    norm,
    pocondest,
    posv,
    posv_array,
    posv_mixed_array,
    potrf,
    potrf_array,
    potrs,
    potrs_array,
    stedc,
    steqr,
    sterf,
    svd_array,
)

__version__ = "0.1.0"
