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
// f32): under a microsecond of the H100's memory or arithmetic rate.  The
// kernel is bound by latency: nb dependent column steps, each a barrier and a
// pass over the trailing block, then nb dependent rows of the inverse.
//
// Design (simple and right first; fast is later work), as chol_diag_inv.cu:
// one CTA of 1024 threads owns the block.  One f32 block is 256 KB, more than
// the 227 KB of shared memory a CTA can have, so the working copy lives in
// global memory (it stays in the 50 MB L2):
//   1. A is copied, column-major, into the U^-1 output, which serves as
//      scratch: a column step then reads and writes consecutive addresses
//      across a warp;
//   2. right-looking column loop, two __syncthreads per column: scale the
//      column below the pivot by it (a zero pivot divides by 1, as
//      _lu_inv_body's denom), then update the trailing block (all 1024
//      threads over a flat index);
//   3. the packed L\U is written row-major;
//   4. column c of U^-1 solves U x = e_c by back substitution, thread c on
//      its own column with no barrier; every row is solved (rows below the
//      diagonal too, zeroed at the end), dividing by the raw diagonal, so a
//      zero pivot spreads inf/NaN exactly as the row-wise loop of
//      _lu_inv_body does.
// unit_linv: column c of unit-L^-1 solves L x = e_c by forward substitution,
// thread c on its own column, every row (zeroed above the diagonal at the
// end), as _unit_linv_body.  No clamping and no early exit: the drivers' info
// code (1 + the first zero or non-finite U diagonal) reads the same index as
// slate_tpu.  Summation order differs from the JAX bodies (which form the
// inverses row by row with a matmul), so results agree to O(eps * cond), not
// bitwise.  The trailing update of step 2 touches rows and columns right of
// and below the pivot only; _lu_inv_body also subtracts 0 * urow from the rows
// above it, which differs only where the block already holds inf or NaN.
// Later work: wgmma on a recursive 2x2 blocking, the block in shared memory
// (f64 halves, packed triangles).
//
// C interface (ctypes), row-major contiguous n x n blocks on the current
// device, launched on `stream`, returning cudaGetLastError() after the launch
// (0 on success); no synchronisation, no allocation:
//   lu_diag_inv_f32 / lu_diag_inv_f64(a, lu, uinv, n, stream)
//   unit_linv_f32 / unit_linv_f64(lu, linv, n, stream)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxN = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_diag_inv_kernel(const T* __restrict__ a, T* __restrict__ lu, T* __restrict__ x, int n) {
  T* w = x;  // column-major working copy: w[c * n + i] holds element (i, c)
  const int tid = threadIdx.x;
  const int nn = n * n;

  // 1. A (row-major) -> w (column-major)
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int c = idx / n, i = idx - c * n;
    w[idx] = a[i * n + c];
  }
  __syncthreads();

  // 2. column loop
  for (int j = 0; j < n; ++j) {
    T* colj = w + j * n;
    const T piv = colj[j];
    const T denom = (piv == T(0)) ? T(1) : piv;
    for (int i = j + 1 + tid; i < n; i += kThreads) colj[i] = colj[i] / denom;
    __syncthreads();  // the multipliers are complete
    const int m = n - j - 1;  // the trailing block is m x m
    for (int idx = tid; idx < m * m; idx += kThreads) {
      const int cc = idx / m, ii = idx - cc * m;
      const int c = j + 1 + cc, i = j + 1 + ii;
      w[c * n + i] -= colj[i] * w[c * n + j];  // l(i, j) * u(j, c); row j is final
    }
    __syncthreads();
  }

  // 3. packed L\U, row-major
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n, c = idx - i * n;
    lu[idx] = w[c * n + i];
  }
  __syncthreads();  // w (aliasing x) is dead from here on

  // 4. X = U^-1, column c by thread c, rows n-1 .. 0
  if (tid < n) {
    const int c = tid;
    for (int i = n - 1; i >= 0; --i) {
      const T* ui = lu + i * n;
      T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
      int k = i + 1;
      for (; k + 3 < n; k += 4) {
        s0 += ui[k] * x[k * n + c];
        s1 += ui[k + 1] * x[(k + 1) * n + c];
        s2 += ui[k + 2] * x[(k + 2) * n + c];
        s3 += ui[k + 3] * x[(k + 3) * n + c];
      }
      for (; k < n; ++k) s0 += ui[k] * x[k * n + c];
      const T e = (i == c) ? T(1) : T(0);
      x[i * n + c] = (e - ((s0 + s1) + (s2 + s3))) / ui[i];
    }
    for (int i = c + 1; i < n; ++i) x[i * n + c] = T(0);  // triu
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unit_linv_kernel(const T* __restrict__ lu, T* __restrict__ x, int n) {
  // column c of unit-L^-1 by thread c, rows 0 .. n-1
  const int c = threadIdx.x;
  if (c >= n) return;
  for (int i = 0; i < n; ++i) {
    const T* li = lu + i * n;
    T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
    int k = 0;
    for (; k + 3 < i; k += 4) {
      s0 += li[k] * x[k * n + c];
      s1 += li[k + 1] * x[(k + 1) * n + c];
      s2 += li[k + 2] * x[(k + 2) * n + c];
      s3 += li[k + 3] * x[(k + 3) * n + c];
    }
    for (; k < i; ++k) s0 += li[k] * x[k * n + c];
    const T e = (i == c) ? T(1) : T(0);
    x[i * n + c] = e - ((s0 + s1) + (s2 + s3));
  }
  for (int i = 0; i < c; ++i) x[i * n + c] = T(0);  // tril
}

template <typename T>
int launch_lu(const void* a, void* lu, void* x, int n, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  lu_diag_inv_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(lu), static_cast<T*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_linv(const void* lu, void* x, int n, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  unit_linv_kernel<T><<<1, kMaxN, 0, static_cast<cudaStream_t>(stream)>>>(
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
