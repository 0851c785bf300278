from .chol import (
    posv,
    posv_array,
    potrf,
    potrf_array,
    potri,
    potri_array,
    potrs,
    potrs_array,
)
from .lu import (
    LUFactors,
    gesv,
    gesv_array,
    getrf,
    getrf_array,
    getrf_nopiv_array,
    getrf_scan_array,
    getrf_tntpiv_array,
    getri_array,
    getri_oop_array,
    getrs_array,
)
from .refine import (
    RefineResult,
    gate_cte,
    gesv_mixed_array,
    gesv_mixed_gmres_array,
    posv_mixed_array,
    posv_mixed_gmres_array,
)
from .tri import trtri_array, trtrm_array
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
from .norms import (
    col_norms,
    gecondest,
    norm,
    norm1est,
    pocondest,
    trcondest,
)
from .tridiag import stedc, stedc_vals, steqr, sterf
from .eig import (
    He2hbFactors,
    he2hb,
    heev_array,
    heev_staged,
    hegst_array,
    hegv_array,
    hb2st,
    unmtr_hb2st,
    unmtr_he2hb,
)
from .svd import (
    Ge2tbFactors,
    bdsqr,
    ge2tb,
    svd_array,
    svd_staged,
    tb2bd,
    unmbr_ge2tb_u,
    unmbr_ge2tb_v,
)
