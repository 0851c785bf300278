from .chol import (
    posv,
    posv_array,
    potrf,
    potrf_array,
    potrs,
    potrs_array,
)
