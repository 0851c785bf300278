// chol_diag_inv.cu -- (L, L^-1) of one nb x nb SPD block, nb <= 256, on Hopper.
//
// Replaces: slate_tpu/ops/pallas_ops.py chol_diag_inv_pallas, the TPU kernel
// that runs _chol_inv_body (a column-loop Cholesky and a row-loop
// forward-substitution inverse) over one VMEM-resident block.  Consumers:
// slate_tpu_torch/linalg/chol.py _potrf_scan (the diagonal block of every
// panel step) and _potrf_and_inv (its 256-wide leaves), and, through
// chol_panel_tiles, the mesh potrf panel.
//
// What bounds it on this card: the work is tiny -- about 2 nb^3 / 3 = 1.1e7
// flops and 3 nb^2 elements moved (0.75 MB in f32), under a microsecond of the
// H100's memory or arithmetic rate.  It is bound by latency: nb dependent
// pivots, the barriers between steps and the L2 round trips of the finished
// panels.  The yardstick is the cuSOLVER + cuBLAS pair on the same card.
//
// Design (csrc/diag_block.cuh has the shared pieces and the reasons): one CTA
// of 256 threads, 32-wide panels, only the current panel in shared memory.
//   1. Left-looking Cholesky, per block column J: the panel of A (lower
//      triangle only; the upper triangle of A is never read) minus
//      L[J:, :J] L[J, :J]^T, the product streamed by cp.async from the
//      finished columns of the L output (which stays in L2) into a
//      double-buffered slab, every warp on an 8 x 4 register tile; warp 0
//      factors the 32 x 32 diagonal block in registers with __shfl_sync;
//      one thread per row solves the rows below against it by substitution;
//      the panel goes to L.  Five block barriers per step (2 n before).
//   2. X = L^-1 by block rows (tri_inverse): the product with the finished
//      rows of X, then substitution with the diagonal block, one column per
//      thread; no thread runs a chain longer than 32 steps of 32 terms.
// Non-SPD input: sqrt of a negative pivot is NaN and spreads through the rest
// of the factor and every later row of the inverse, exactly as in
// _chol_inv_body -- no clamping, no early exit, the NaN/finite masks equal the
// twin's, so the drivers' info code (1 + first bad diagonal) reads the same
// column.  Values agree with the twin to O(eps cond(L)), not bitwise.
//
// C interface (ctypes): chol_diag_inv_f32 / chol_diag_inv_f64(a, l, x, n,
// stream) with row-major contiguous n x n a, l, x on the current device;
// returns the error of setting the shared-memory limit or of the launch
// (0 on success).  No synchronisation, no allocation.

#include "diag_block.cuh"

namespace {

using namespace diag_block;

// Left-looking blocked Cholesky of the lower triangle of a into l (upper
// triangle zero), the panel in sm.panel, the slabs in sm.slab.
template <typename T>
__device__ void potrf_blocked(const T* a, T* l, int n, Smem<T> sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 3, tx = tid & 7;
  const int npad = (n + kB - 1) / kB * kB, nt = npad / kB;
  const Geo<false> g{n, npad};
  T* sP = sm.panel;
  for (int J = 0; J < nt; ++J) {
    const int jb = J * kB, mg = nt - J, m = mg * kB;
    T acc[8][4];
    Gemm<T, true, true, false, false>{sm.slab, l, jb, l, jb, g, J, mg, 0, 3}.run(acc, J > 1);
    // A's panel: the lower triangle, the identity where padded; all loads
    // issued before the first store
    T init[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int gi = jb + ty + 32 * r, gj = jb + tx + 8 * jj;
        init[r][jj] = r >= mg ? T(0)
                      : (gi < n && gj < n) ? (gi >= gj ? a[gi * n + gj] : T(0))
                                           : (gi == gj ? T(1) : T(0));
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the product's stages are read; the panel is the third
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < mg) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sP[(ty + 32 * r) * kLdP + tx + 8 * jj] = init[r][jj] - acc[r][jj];
      }
    }
    __syncthreads();
    // the next step's first slab (L's first block column, final since step 0)
    // in flight during this step's factor, solve and stores
    if (J >= 1 && J + 1 < nt) {
      Gemm<T, true, true, false, false>{sm.slab, l, jb + kB, l, jb + kB, g, J + 1, mg - 1, 0, 3}.issue(0);
    }
    if (warp == 0) warp_potrf(sP, sm.diag, sm.rcp, lane);
    __syncthreads();
    for (int w = tid; w < m - kB; w += kThreads) row_solve<T, true>(sP + (kB + w) * kLdP, sP, sm.rcp);
    __syncthreads();
    // the block column of L in full: zero above the diagonal block; 16 bytes
    // a store where n allows
    auto value = [&](int gi, int j) { return gi < jb ? T(0) : sP[(gi - jb) * kLdP + j]; };
    if (n % Lay<T>::kVec == 0 && reinterpret_cast<size_t>(l) % 16 == 0) {
      constexpr int V = Lay<T>::kVec, kPer = kB / V;
      for (int q = tid; q < n * kPer; q += kThreads) {
        const int gi = q / kPer, j = (q % kPer) * V, gj = jb + j;
        if (gj >= n) continue;
        T o[V];
#pragma unroll
        for (int u = 0; u < V; ++u) o[u] = value(gi, j + u);
        st16(l + gi * n + gj, o);
      }
    } else {
      for (int idx = tid; idx < n * kB; idx += kThreads) {
        const int gi = idx / kB, j = idx % kB, gj = jb + j;
        if (gj < n) l[gi * n + gj] = value(gi, j);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
chol_diag_inv_kernel(const T* __restrict__ a, T* l, T* x, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_first;
  const Smem<T> sm(smem);
  potrf_blocked<T>(a, l, n, sm);
  tri_inverse<T, false, false>(l, x, n, sm, &s_first);
}

template <typename T>
int launch(const void* a, void* l, void* x, int n, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<T, chol_diag_inv_kernel<T>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_diag_inv_kernel<T><<<1, kThreads, smem_bytes<T>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(l), static_cast<T*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int chol_diag_inv_f32(const void* a, void* l, void* x, int n, void* stream) {
  return launch<float>(a, l, x, n, stream);
}

extern "C" int chol_diag_inv_f64(const void* a, void* l, void* x, int n, void* stream) {
  return launch<double>(a, l, x, n, stream);
}
