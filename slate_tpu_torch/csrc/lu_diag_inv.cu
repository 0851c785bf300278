// lu_diag_inv.cu -- the no-pivot LU of one nb x nb diagonal block, nb <= 256,
// and the inverses the LU panel solves consume, on Hopper (sm_90a).
//
// Replaces the diagonal-block halves of two TPU kernels of
// slate_tpu/ops/pallas_ops.py:
//   :543 lu_panel_tiles_pallas     step 0, _lu_inv_body: packed L\U + U^-1
//   :590 lu_rowsolve_tiles_pallas  step 0, _unit_linv_body: unit-L^-1 of a packed L\U
// Their tile solves (steps 1..L: A_i U^-1 and L^-1 A_j) run on csrc/tile_gemm.cu.
// Wrappers: slate_tpu_torch/ops/kernels.py (lu_panel_tiles, lu_rowsolve_tiles,
// through _launch_lu); consumer: parallel/dist_lu.py, the panel
// of every step of the no-pivot and tournament-pivoted mesh LU and the panel
// row of the partial-pivot one.
//
// What bounds it on this card: the work is tiny -- about 2 nb^3 / 3 flops for
// the factor, nb^3 / 3 for each inverse, and 3 nb^2 elements moved (0.75 MB in
// f32): under a microsecond of the H100's memory or arithmetic rate.  It is
// bound by latency: nb dependent pivots, the barriers between steps and the L2
// round trips of the finished panels.  The yardstick is the library pair on
// the same card.
//
// Design (csrc/diag_block.cuh has the shared pieces and the reasons): one CTA
// of 256 threads, 32-wide panels, only the current panels in shared memory.
//   1. Crout LU, per step J: the block column A[J:, J] minus L[J:, :J] U[:J, J]
//      and the block row A[J, J+1:] minus L[J, :J] U[:J, J+1:], both products
//      streamed by cp.async from the finished panels of the L\U output (in
//      L2), every warp on an 8 x 4 register tile; warp 0 factors the 32 x 32
//      diagonal block in registers with __shfl_sync (the pivot divides by 1
//      where it is 0, as _lu_inv_body's denom); then, one thread per row or
//      column, the L rows below solve against U_JJ by substitution with the
//      same denom rule (an explicit U_JJ^-1 would put inf/NaN where the
//      column loop stays finite) and the U columns right of it against
//      unit-L_JJ.  Crout reads A once and needs no trailing matrix on chip.
//   2. U^-1 (tri_inverse on the exchange mirror J U J, which is lower
//      triangular): block rows from the bottom, the product with the finished
//      rows, then substitution dividing by the raw diagonal, one column per
//      thread.  A zero pivot gives inf/NaN exactly where _lu_inv_body's
//      full-row back substitution does: every row above the last zero pivot
//      (tri_inverse says why the structurally zero blocks need a rule).
// unit_linv: tri_inverse on the strict lower triangle with a unit diagonal,
// as _unit_linv_body.  No clamping and no early exit: the drivers' info code
// (1 + the first zero or non-finite U diagonal) reads the same index as
// slate_tpu.  Values agree with the twins to O(eps cond), not bitwise.  The
// factor updates rows and columns right of and below each pivot only;
// _lu_inv_body also subtracts 0 * urow from the rows above it, which differs
// only where the block already holds inf or NaN.
//
// C interface (ctypes), row-major contiguous n x n blocks on the current
// device, launched on `stream`, returning the error of setting the
// shared-memory limit or of the launch (0 on success); no synchronisation, no
// allocation:
//   lu_diag_inv_f32 / lu_diag_inv_f64(a, lu, uinv, n, stream)
//   unit_linv_f32 / unit_linv_f64(lu, linv, n, stream)

#include "diag_block.cuh"

namespace {

using namespace diag_block;

// Crout LU without pivoting of a into lu (packed L\U), the block column in
// sm.panel and the block row (transposed: one row per column of U) in sm.slab.
template <typename T>
__device__ void getrf_crout(const T* a, T* lu, int n, Smem<T> sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 3, tx = tid & 7;
  const int npad = (n + kB - 1) / kB * kB, nt = npad / kB;
  const Geo<false> g{n, npad};
  T* sP = sm.panel;
  for (int J = 0; J < nt; ++J) {
    const int jb = J * kB, mg = nt - J, m = mg * kB, w = m - kB;
    T acc[8][4];
    // block column: A[jb:, jb:jb+32] - L[jb:, :jb] U[:jb, jb:jb+32], its slabs
    // from stage 1 on (slab 0 was prefetched there: stage 0 held the block row)
    Gemm<T, true, false, false, false>{sm.slab, lu, jb, lu, jb, g, J, mg, 1, 3}.run(acc, J > 1);
    T init[8][4];  // A's part (the identity where padded), loaded before any store
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int gi = jb + ty + 32 * r, gj = jb + tx + 8 * jj;
        init[r][jj] = r >= mg ? T(0) : (gi < n && gj < n) ? a[gi * n + gj] : (gi == gj ? T(1) : T(0));
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the product's stages are read; the block column is the third
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < mg) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sP[(ty + 32 * r) * kLdP + tx + 8 * jj] = init[r][jj] - acc[r][jj];
      }
    }
    // block row, transposed: A[jb:jb+32, jb+32:]^T - U[:jb, jb+32:]^T L[jb:jb+32, :jb]^T
    // (two stages: the block column is live in the third)
    Gemm<T, false, true, false, false>{sm.slab, lu, jb + kB, lu, jb, g, J, mg - 1, 0, 2}.run(acc, false);
#pragma unroll
    for (int r = 0; r < 7; ++r) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int gi = jb + tx + 8 * jj, gj = jb + kB + ty + 32 * r;
        init[r][jj] = (r < mg - 1 && gi < n && gj < n) ? a[gi * n + gj] : T(0);
      }
    }
    __syncthreads();  // the row product's stages are read; the block row takes stage 0
    T* sR = sm.slab;
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      if (r < mg - 1) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sR[(ty + 32 * r) * kLdP + tx + 8 * jj] = init[r][jj] - acc[r][jj];
      }
    }
    __syncthreads();
    // the next step's first column slab (final since step 0) into stage 1, in
    // flight during this step's factor, solves and stores
    if (J >= 1 && J + 1 < nt) {
      Gemm<T, true, false, false, false>{sm.slab, lu, jb + kB, lu, jb + kB, g, J + 1, mg - 1, 1, 3}.issue(0);
    }
    if (warp == 0) warp_getrf(sP, sm.diag, sm.rcp, lane);
    __syncthreads();
    // L rows below the diagonal block (in sP), U columns right of it (to lu)
    for (int q = tid; q < 2 * w; q += kThreads) {
      if (q < w) {
        row_solve<T, false>(sP + (kB + q) * kLdP, sP, sm.rcp);
      } else {
        const int c = q - w, gj = jb + kB + c;
        T v[kB];
#pragma unroll
        for (int j = 0; j < kB; ++j) v[j] = sR[c * kLdP + j];
#pragma unroll
        for (int j = 0; j < kB; ++j)
#pragma unroll
          for (int j2 = j + 1; j2 < kB; ++j2) v[j2] -= sP[j2 * kLdP + j] * v[j];
        if (gj < n) {
#pragma unroll
          for (int j = 0; j < kB; ++j)
            if (jb + j < n) lu[(jb + j) * n + gj] = v[j];
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < m * kB; idx += kThreads) {
      const int i = idx / kB, j = idx % kB, gi = jb + i, gj = jb + j;
      if (gi < n && gj < n) lu[gi * n + gj] = sP[i * kLdP + j];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lu_diag_inv_kernel(const T* __restrict__ a, T* lu, T* x, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_first;
  const Smem<T> sm(smem);
  getrf_crout<T>(a, lu, n, sm);
  tri_inverse<T, false, true>(lu, x, n, sm, &s_first);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
unit_linv_kernel(const T* __restrict__ lu, T* x, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_first;
  const Smem<T> sm(smem);
  tri_inverse<T, true, false>(lu, x, n, sm, &s_first);
}

template <typename T>
int launch_lu(const void* a, void* lu, void* x, int n, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<T, lu_diag_inv_kernel<T>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  lu_diag_inv_kernel<T><<<1, kThreads, smem_bytes<T>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(lu), static_cast<T*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_linv(const void* lu, void* x, int n, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<T, unit_linv_kernel<T>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  unit_linv_kernel<T><<<1, kThreads, smem_bytes<T>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(lu), static_cast<T*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lu_diag_inv_f32(const void* a, void* lu, void* x, int n, void* stream) {
  return launch_lu<float>(a, lu, x, n, stream);
}

extern "C" int lu_diag_inv_f64(const void* a, void* lu, void* x, int n, void* stream) {
  return launch_lu<double>(a, lu, x, n, stream);
}

extern "C" int unit_linv_f32(const void* lu, void* x, int n, void* stream) {
  return launch_linv<float>(lu, x, n, stream);
}

extern "C" int unit_linv_f64(const void* lu, void* x, int n, void* stream) {
  return launch_linv<double>(lu, x, n, stream);
}
