from .chol import (
    posv,
    posv_array,
    potrf,
    potrf_array,
    potrs,
    potrs_array,
)
from .qr import (
    LQFactors,
    QRFactors,
    cholqr_array,
    gelqf_array,
    gels_array,
    gels_cholqr_array,
    gels_qr_array,
    geqrf_array,
    geqrf_q,
    geqrf_r,
    unmlq_array,
    unmqr_array,
)
