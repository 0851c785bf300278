"""slate_tpu_torch — the PyTorch/CUDA port of slate_tpu.

A second package beside ``slate_tpu`` (the JAX reference, which this package
never imports).  This first slice is the single-chip SPD solve (dposv): the
matrix views, the matmul dispatch, the recursive triangular solve, the three
Cholesky forms of ``slate_tpu.linalg.chol`` and a hand-written Hopper kernel
for the diagonal-block factor + inverse (``ops/kernels.py``,
``csrc/chol_diag_inv.cu``).  Entry points compute on the tensors' device:
pass CUDA tensors for the card, CPU tensors for the plain twins.
"""

from .types import Diag, Op, Option, Precision, Side, SlateError, Target, Uplo
from .core import BaseMatrix, HermitianMatrix, TriangularMatrix
from .blas3 import gemm, trsm
from . import api, linalg, ops
from .linalg import posv, posv_array, potrf, potrf_array, potrs, potrs_array

__version__ = "0.1.0"
