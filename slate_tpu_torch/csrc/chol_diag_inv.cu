// chol_diag_inv.cu -- (L, L^-1) of one nb x nb SPD block, nb <= 256, on Hopper.
//
// Replaces: slate_tpu/ops/pallas_ops.py chol_diag_inv_pallas, the TPU kernel
// that runs _chol_inv_body (a column-loop Cholesky and a row-loop
// forward-substitution inverse) over one VMEM-resident block.  Consumers:
// slate_tpu_torch/linalg/chol.py _potrf_scan (the diagonal block of every
// panel step) and _potrf_and_inv (its 256-wide leaves).
//
// What bounds it on this card: the work is tiny -- about 2 nb^3 / 3 = 1.1e7
// flops and 3 nb^2 elements moved (0.75 MB in f32), under a microsecond of the
// H100's memory or arithmetic rate.  The kernel is bound by latency: nb
// dependent column steps, each a barrier and a pass over the trailing
// triangle, then nb dependent rows of the inverse.
//
// Design (simple and right first; fast is later work): one CTA of 1024
// threads owns the block.  One f32 block is 256 KB, more than the 227 KB of
// shared memory a CTA can have, so the working copy lives in global memory
// (it stays in the 50 MB L2):
//   1. the lower triangle of A is copied, column-major, into the X output,
//      which serves as scratch: a column step then reads and writes
//      consecutive addresses across a warp;
//   2. right-looking column loop, two __syncthreads per column: pivot
//      d = sqrt(w_jj), scale the column below it, update the trailing lower
//      triangle (all 1024 threads over a flat index);
//   3. L is written row-major with zeros above the diagonal;
//   4. column c of L^-1 solves L x = e_c; thread c solves its own column with
//      no barrier at all, four partial sums to shorten the dependent chain.
// Non-SPD input: sqrt of a negative pivot is NaN and spreads down the rest of
// the factor and the inverse, exactly as in _chol_inv_body -- no clamping and
// no early exit, so the drivers' info code (1 + first bad diagonal) reads the
// same column.  Summation order differs from the JAX body (which forms L^-1
// row by row with a matmul), so results agree to O(eps * cond(L)), not bitwise.
// Later work: wgmma on a recursive 2x2 blocking, a packed triangle in shared
// memory.
//
// C interface (ctypes): chol_diag_inv_f32 / chol_diag_inv_f64(a, l, x, n,
// stream) with row-major contiguous n x n a, l, x on the current device;
// returns cudaGetLastError() after the launch (0 on success).  No
// synchronisation, no allocation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxN = 256;

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_diag_inv_kernel(const T* __restrict__ a, T* __restrict__ l, T* __restrict__ x, int n) {
  T* w = x;  // column-major working copy: w[c * n + i] holds element (i, c)
  const int tid = threadIdx.x;
  const int nn = n * n;

  // 1. lower triangle of A (row-major) -> w (column-major); the upper
  //    triangle of A is never read
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int c = idx / n, i = idx - c * n;
    w[idx] = (i >= c) ? a[i * n + c] : T(0);
  }
  __syncthreads();

  // 2. column loop
  for (int j = 0; j < n; ++j) {
    T* colj = w + j * n;
    const T d = dev_sqrt(colj[j]);
    for (int i = j + 1 + tid; i < n; i += kThreads) colj[i] = colj[i] / d;
    __syncthreads();  // the scaled column is complete; every thread has read w_jj
    if (tid == 0) colj[j] = d;
    const int m = n - j - 1;  // trailing block is m x m, lower part updated
    for (int idx = tid; idx < m * m; idx += kThreads) {
      const int cc = idx / m, ii = idx - cc * m;
      if (ii >= cc) {
        const int c = j + 1 + cc, i = j + 1 + ii;
        w[c * n + i] -= colj[i] * colj[c];
      }
    }
    __syncthreads();
  }

  // 3. L, row-major, zero above the diagonal
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n, c = idx - i * n;
    l[idx] = (i >= c) ? w[c * n + i] : T(0);
  }
  __syncthreads();  // w (aliasing x) is dead from here on

  // 4. X = L^-1, column c by thread c
  if (tid < n) {
    const int c = tid;
    for (int i = 0; i < c; ++i) x[i * n + c] = T(0);
    for (int i = c; i < n; ++i) {
      const T* li = l + i * n;
      T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
      int k = c;
      for (; k + 3 < i; k += 4) {
        s0 += li[k] * x[k * n + c];
        s1 += li[k + 1] * x[(k + 1) * n + c];
        s2 += li[k + 2] * x[(k + 2) * n + c];
        s3 += li[k + 3] * x[(k + 3) * n + c];
      }
      for (; k < i; ++k) s0 += li[k] * x[k * n + c];
      const T e = (i == c) ? T(1) : T(0);
      x[i * n + c] = (e - ((s0 + s1) + (s2 + s3))) / li[i];
    }
  }
}

template <typename T>
int launch(const void* a, void* l, void* x, int n, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  chol_diag_inv_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
