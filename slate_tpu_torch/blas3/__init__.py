from .blas3 import gemm, gemm_array, trsm, trsm_array
