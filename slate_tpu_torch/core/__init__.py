from .matrix import (
    BaseMatrix,
    HermitianMatrix,
    TriangularMatrix,
    symmetrize,
    tri_project,
)
