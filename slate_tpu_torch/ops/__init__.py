from .tile_ops import (
    col_norms,
    gbnorm,
    geadd,
    gecopy,
    genorm,
    gescale,
    gescale_row_col,
    geset,
    hbnorm,
    henorm,
    synorm,
    transpose,
    trnorm,
    tzadd,
    tzcopy,
    tzscale,
    tzset,
)
from .matmul import matmul, matmul_pallas
from .ozaki import matmul_f64
