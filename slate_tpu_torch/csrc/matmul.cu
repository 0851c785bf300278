// matmul.cu -- C = A B with the products summed in full f32, for Hopper (sm_90a).
//
// Replaces: slate_tpu/ops/matmul.py:73 matmul_pallas (its pallas_call at :86),
// the TPU's blocked GEMM over a (M/bm, N/bn, K/bk) grid with an f32 VMEM
// accumulator and precision HIGHEST (full f32 on the MXU).  Wrapper:
// slate_tpu_torch/ops/kernels.py matmul_pallas (its plain twin
// matmul_pallas_plain); public entry slate_tpu_torch/ops/matmul.py
// matmul_pallas.  As in slate_tpu, no driver reaches it: the default
// dispatch (_use_pallas) never takes it.
//
// What it computes is the TPU kernel's function, not its block structure:
// C (m x n) = A (m x k) B (k x n), every product and sum in f32 (FFMA; no
// TF32), C written in A's dtype.  Operands f32, bf16 or f16 (bf16/f16 loads
// widened to f32, the output rounded once to nearest even).  f64 and complex
// are refused by the wrapper: the TPU kernel takes neither either.
//
// What bounds it on this card: operations.  2 m n k flops against
// (m k + k n + m n) elements: at 8192^3 f32 that is 1.1e12 flops over
// 805 MB, 1365 flops per byte, far above the H100's 20 flops per HBM byte.
// The f32 product's bound is the CUDA cores' 67 TFLOP/s (16.4 ms at 8192^3);
// the bf16 product's is the tensor cores' 989 TFLOP/s (dense, 1.1 ms at
// 8192^3), which only wgmma fed by TMA reaches -- a later PR's work (ROADMAP,
// the kernels queue).  This kernel runs bf16 and f16 at the FFMA rate.
//
// Tolerance against the twin (utils.testing.matmul_pallas_excess, in f64 on
// the card): |C - C_twin| <= 9 sqrt(k) eps32 (|A||B|) elementwise, the two
// f32 sums taken in different orders, each within Higham and Mary's
// probabilistic bound lambda sqrt(k) u (|A||B|), lambda = 9; a bf16/f16
// output adds one ulp of its dtype (each side rounds its f32 sum once).  Not
// bitwise.
//
// Design (simple and right first): one CTA of 256 threads owns a 128 x 128
// tile of C and walks k in 8-deep slabs staged through shared memory; each
// thread keeps 8 x 8 f32 accumulators (rows ty + 16 i, columns tx + 16 j), so
// a slab costs 16 shared-memory reads per 64 FFMAs.  Ragged edges are masked
// in the loads (zeros) and the stores: nothing is padded in device memory.
// Each element sums its k products in k order with one FFMA each.  The A
// slab is stored k-major with 4 floats of padding per row, so the staging
// stores hit distinct banks.  Left on the table: the tensor cores, TMA and a
// multi-stage pipeline, vector loads.
//
// C interface (ctypes): matmul_f32 / matmul_bf16 / matmul_f16(a, b, c, m, n,
// k, sam, sak, sbk, sbn, stream) -- A and B by element strides (any layout),
// C contiguous row-major (m, n) in the operands' dtype.  Returns
// cudaGetLastError() after the launch (0 on success).  No synchronisation,
// no allocation.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                  // C tile rows per CTA
constexpr int BN = 128;                  // C tile columns per CTA
constexpr int BK = 8;                    // k-slab through shared memory
constexpr int TD = 16;                   // threads per tile dim
constexpr int TM = BM / TD;              // 8 rows per thread
constexpr int TN = BN / TD;              // 8 columns per thread
constexpr int kThreads = TD * TD;        // 256
constexpr int kPad = 4;                  // As row padding (bank spread)
constexpr unsigned kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
              int64_t m, int64_t n, int64_t k, int64_t sam, int64_t sak, int64_t sbk,
              int64_t sbn) {
  __shared__ float As[BK][BM + kPad];  // As[kk][r] = A(m0 + r, k0 + kk)
  __shared__ float Bs[BK][BN];         // Bs[kk][c] = B(k0 + kk, n0 + c)
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TD, ty = tid / TD;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int s = 0; s < BM * BK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      // A: neighbouring threads on neighbouring k (a row-major row is contiguous)
      const int ar = e / BK, ak = e % BK;
      const int64_t gm = m0 + ar, gk = k0 + ak;
      As[ak][ar] = (gm < m && gk < k) ? to_f32(A[gm * sam + gk * sak]) : 0.0f;
      // B: neighbouring threads on neighbouring columns
      const int bk = e / BN, bc = e % BN;
      const int64_t hk = k0 + bk, hn = n0 + bc;
      Bs[bk][bc] = (hk < k && hn < n) ? to_f32(B[hk * sbk + hn * sbn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + TD * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + TD * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty + TD * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx + TD * j;
      if (gn < n) C[gm * n + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, long long m, long long n, long long k,
           long long sam, long long sak, long long sbk, long long sbn, void* stream) {
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const long long gx = (n + BN - 1) / BN, gy = (m + BM - 1) / BM;
  if (gy > kMaxGridY || gx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  matmul_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), m, n, k, sam,
      sak, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int matmul_f32(const void* a, const void* b, void* c, long long m, long long n,
                          long long k, long long sam, long long sak, long long sbk,
                          long long sbn, void* stream) {
  return launch<float>(a, b, c, m, n, k, sam, sak, sbk, sbn, stream);
}

extern "C" int matmul_bf16(const void* a, const void* b, void* c, long long m, long long n,
                           long long k, long long sam, long long sak, long long sbk,
                           long long sbn, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, n, k, sam, sak, sbk, sbn, stream);
}

extern "C" int matmul_f16(const void* a, const void* b, void* c, long long m, long long n,
                          long long k, long long sam, long long sak, long long sbk,
                          long long sbn, void* stream) {
  return launch<__half>(a, b, c, m, n, k, sam, sak, sbk, sbn, stream);
}
