from .matrix import (
    BandMatrix,
    BaseMatrix,
    HermitianBandMatrix,
    HermitianMatrix,
    Matrix,
    SymmetricMatrix,
    TrapezoidMatrix,
    TriangularBandMatrix,
    TriangularMatrix,
    band_project,
    symmetrize,
    tri_project,
)
