"""The mesh layer of the port: a virtual (p, q) process grid on one card,
the block-cyclic DistMatrix, the communication verbs, and the distributed
Cholesky, triangular solve and GEMM -- ``slate_tpu.parallel``'s names for
the slice that runs the distributed SPD solve (potrf_dist -> trsm_dist ->
gemm_summa).  The other mesh drivers come with their slices."""

from .mesh import COL_AXIS, ROW_AXIS, VirtualMesh, make_mesh, mesh_shape
from .dist import DistMatrix, empty_like, from_dense, local_view, padded_tiles, to_dense
from .summa import gemm_summa
from .dist_chol import potrf_dist
from .dist_trsm import trsm_dist
