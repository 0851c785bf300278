"""The mesh layer of the port: a virtual (p, q) process grid on one card,
the block-cyclic DistMatrix, the communication verbs, the distributed
Cholesky, LU (no-pivot, tournament and partial pivot), triangular solves
(left and right), GEMM, hemm / symm, trmm, herk, her2k / syr2k and the
tile-grid transpose, CAQR, the norms and condition estimators, and the
mesh drivers -- ``slate_tpu.parallel``'s names for the slices that run the
distributed SPD solve (posv_mesh: potrf_dist -> trsm_dist), the mesh gemm
(gemm_mesh: gemm_summa), the distributed LU solves (gesv_mesh,
gesv_nopiv_mesh, gesv_tntpiv_mesh), the distributed least squares
(geqrf_mesh, gels_mesh: geqrf_dist -> unmqr_dist -> trsm_dist), the
rank-2k update (her2k_mesh), the inverses (getri_mesh, potri_mesh), the
band multiplies (gbmm_mesh, hbmm_mesh), the two-stage eigensolver and SVD
(heev_mesh, svd_mesh: he2hb_dist / ge2tb_dist, the sharded stedc_dist,
chase_apply_dist and the stage-1 back-transforms), with Option.FaultTolerance routing
to ``ft.abft``, and the mixed-precision ladder behind the f64 posv_mesh /
gesv_mesh (posv_mixed_mesh, gesv_mixed_mesh and their GMRES-IR forms, the
Ozaki residual gemm_summa_ozaki, norm_dist).  The other mesh drivers come
with their slices."""

from .mesh import COL_AXIS, ROW_AXIS, VirtualMesh, make_mesh, mesh_shape
from .dist import DistMatrix, empty_like, from_dense, local_view, padded_tiles, to_dense
from .summa import OzakiSplit, gemm_summa, gemm_summa_ozaki, ozaki_presplit, ozaki_presplit_cached
from .dist_chol import potrf_dist
from .dist_blas3 import hemm_summa, her2k_dist, syr2k_dist, transpose_dist, trmm_dist
from .dist_trsm import trsm_dist, trsm_dist_right
from .dist_lu import getrf_nopiv_dist, getrf_pp_dist, getrf_tntpiv_dist, permute_rows_dist
from .dist_qr import DistQR, geqrf_dist, unmqr_dist
from .dist_aux import gecondest_dist, herk_dist, norm_dist, pocondest_dist
from .dist_stedc import stedc_dist
from .dist_twostage import (
    DistTwoStage,
    chase_apply_dist,
    gather_diagband,
    ge2tb_dist,
    he2hb_dist,
    unmbr_ge2tb_u_dist,
    unmbr_ge2tb_v_dist,
    unmtr_he2hb_dist,
)
from .dist_refine import (
    MIXED_ENV,
    MIXED_MODES,
    RESIDUAL_ENV,
    RESIDUAL_IMPLS,
    resolve_mixed,
    resolve_residual_impl,
    use_mixed,
)
from .drivers import (
    gbmm_mesh,
    gels_mesh,
    gemm_mesh,
    geqrf_mesh,
    gesv_mesh,
    gesv_mixed_gmres_mesh,
    gesv_mixed_mesh,
    gesv_nopiv_mesh,
    gesv_tntpiv_mesh,
    getrf_mesh,
    heev_mesh,
    getrf_nopiv_mesh,
    getrf_tntpiv_mesh,
    getri_mesh,
    hbmm_mesh,
    her2k_mesh,
    posv_mesh,
    posv_mixed_gmres_mesh,
    posv_mixed_mesh,
    potri_mesh,
    potrf_mesh,
    svd_mesh,
)
