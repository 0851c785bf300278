// tile_gemm.cu -- batched, masked per-tile GEMM over the local tile stacks of
// a virtual (p, q) mesh, for Hopper (sm_90a).
//
// One source for three TPU kernels of slate_tpu/ops/pallas_ops.py:
//   :711 summa_update_pallas          acc[i, j] += pan[i] @ urow[j]          (mode add, op N)
//   :738 chol_trailing_update_pallas  view[i, j] -= mask[i, j] ? pan[i] @ pan_t[j]^T : 0
//                                                                           (mode sub, op T, mask)
//   :491 chol_panel_tiles_pallas      its solve half, s[i] = A_i @ L^-T     (mode set, op T, B shared)
// Wrappers: slate_tpu_torch/ops/kernels.py (summa_update, chol_trailing_update,
// chol_panel_tiles; the last also launches chol_diag_inv.cu for L_kk, L^-1).
//
// What it computes: for every grid device (r, q) of the virtual mesh, every
// tile row i < I and tile column j < J of the local stack,
//   C[r,q,i,j] (=, +=, -=) A[r,q,i] . op(B[r,q,j])        (nb x nb tiles, K = nb)
// skipping the tile where mask[r,q,i,j] == 0.  All operands are strided views
// (element strides per dim, 0 for an operand shared along a dim): the trailing
// view of a bucket (t_loc[s0r:, s0c:]) is not contiguous, and a broadcast panel
// is read by every mesh column through stride 0 -- no copies.  One launch covers
// the whole mesh: the TPU runs one pallas_call per device per k-step.
//
// What bounds it on this card: operations.  An unmasked tile costs 2 nb^3 flops
// (3.4e7 at nb = 256) against 3 nb^2 elements moved, 85 flops per f32 byte and
// 43 per f64 byte, above the H100's 20 flops per HBM byte (67 TFLOP/s f32
// outside the tensor cores and 67 TFLOP/s f64 on the FP64 tensor cores,
// 3.35 TB/s).  The panel solve's L^-T is triangular, so that work needs only
// nb^3 flops per tile; this kernel spends 2 nb^3 on the dense form.  Summation order: each output
// element sums its nb products in k order with one fused multiply-add each
// (FFMA / DFMA; no TF32, as the Pallas kernels run precision=HIGHEST), then
// applies the mode once -- independent of the grid, of J and of the mask, so a
// column refreshed alone (the lookahead narrow update, J = 1) gets the same
// bits as in the full update.
//
// Design (simple and right first): one CTA of 256 threads computes one 64 x 64
// sub-block of one output tile (16 CTAs per nb = 256 tile), staging 16-deep
// k-chunks of A and op(B) through shared memory; each thread keeps 4 x 4
// accumulators.  A masked tile's CTAs return before reading anything, so the
// update is in place and the masked half of the Cholesky trailing window costs
// only the launch of empty CTAs.  What it leaves on the table: the tensor
// cores (wgmma, TF32/bf16x3 emulation would be a precision change), TMA and a
// multi-stage pipeline, register blocking beyond 4 x 4 (shared-memory
// bandwidth caps this form at a fraction of the FFMA peak), and persistent
// CTAs over the masked grid.
//
// C interface (ctypes): tile_gemm_f32 / tile_gemm_f64(a, b, c, mask, geom,
// stream); geom points to 28 int64 host values
//   R, Q, I, J, nb, sa[5] (r, q, i, row, col), sb[5] (r, q, j, row, col),
//   sc[6] (r, q, i, j, row, col), sm[4] (r, q, i, j), trans_b, mode, has_mask
// (mode 0: C = AB, 1: C += AB, 2: C -= AB; mask is int32, ignored when
// has_mask is 0).  Returns cudaGetLastError() after the launch (0 on
// success).  No synchronisation, no allocation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                             // output sub-block per CTA
constexpr int BK = 16;                             // k-chunk through shared memory
constexpr int TM = 4;                              // outputs per thread per dim
constexpr int TD = BM / TM;                        // 16 threads per dim
constexpr int kThreads = TD * TD;                  // 256
constexpr int kGeom = 28;

struct Geom {
  int64_t R, Q, I, J, nb;
  int64_t sa[5];
  int64_t sb[5];
  int64_t sc[6];
  int64_t sm[4];
  int trans_b, mode, has_mask;
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* C,
                 const int* __restrict__ M, Geom g) {
  const int64_t nsub = (g.nb + BM - 1) / BM;
  int64_t t = blockIdx.x;
  const int64_t sub = t % (nsub * nsub);
  t /= nsub * nsub;
  const int64_t j = t % g.J;
  t /= g.J;
  const int64_t i = t % g.I;
  t /= g.I;
  const int64_t q = t % g.Q;
  const int64_t r = t / g.Q;
  if (g.has_mask && M[r * g.sm[0] + q * g.sm[1] + i * g.sm[2] + j * g.sm[3]] == 0) return;

  const int64_t m0 = (sub / nsub) * BM, n0 = (sub % nsub) * BM;
  const T* a = A + r * g.sa[0] + q * g.sa[1] + i * g.sa[2];
  const T* b = B + r * g.sb[0] + q * g.sb[1] + j * g.sb[2];
  T* c = C + r * g.sc[0] + q * g.sc[1] + i * g.sc[2] + j * g.sc[3];

  __shared__ T As[BK][BM + 1];  // As[k][m] = A(m0 + m, k0 + k)
  __shared__ T Bs[BK][BM + 1];  // Bs[k][n] = op(B)(k0 + k, n0 + n)
  const int tid = threadIdx.x;
  const int tx = tid % TD, ty = tid / TD;

  T acc[TM][TM];
#pragma unroll
  for (int x = 0; x < TM; ++x)
#pragma unroll
    for (int y = 0; y < TM; ++y) acc[x][y] = T(0);

  for (int64_t k0 = 0; k0 < g.nb; k0 += BK) {
#pragma unroll
    for (int s = 0; s < BM * BK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      // A: neighbouring threads on neighbouring k (a tile row is contiguous)
      const int am = e / BK, ak = e % BK;
      const int64_t gm = m0 + am, gk = k0 + ak;
      As[ak][am] = (gm < g.nb && gk < g.nb) ? a[gm * g.sa[3] + gk * g.sa[4]] : T(0);
      // op(B): neighbouring threads on neighbouring addresses of B
      int bk, bn;
      if (g.trans_b) {
        bn = e / BK;
        bk = e % BK;
      } else {
        bk = e / BM;
        bn = e % BM;
      }
      const int64_t hk = k0 + bk, hn = n0 + bn;
      T v = T(0);
      if (hk < g.nb && hn < g.nb)
        v = g.trans_b ? b[hn * g.sb[3] + hk * g.sb[4]] : b[hk * g.sb[3] + hn * g.sb[4]];
      Bs[bk][bn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T av[TM], bv[TM];
#pragma unroll
      for (int x = 0; x < TM; ++x) {
        av[x] = As[kk][ty + TD * x];
        bv[x] = Bs[kk][tx + TD * x];
      }
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TM; ++y) acc[x][y] = fma_rn(av[x], bv[y], acc[x][y]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int64_t gm = m0 + ty + TD * x;
    if (gm >= g.nb) continue;
#pragma unroll
    for (int y = 0; y < TM; ++y) {
      const int64_t gn = n0 + tx + TD * y;
      if (gn >= g.nb) continue;
      T* out = c + gm * g.sc[4] + gn * g.sc[5];
      if (g.mode == 0)
        *out = acc[x][y];
      else if (g.mode == 1)
        *out = *out + acc[x][y];
      else
        *out = *out - acc[x][y];
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, const void* mask, const long long* geom,
           void* stream) {
  Geom g;
  const long long* v = geom;
  g.R = v[0]; g.Q = v[1]; g.I = v[2]; g.J = v[3]; g.nb = v[4];
  for (int d = 0; d < 5; ++d) g.sa[d] = v[5 + d];
  for (int d = 0; d < 5; ++d) g.sb[d] = v[10 + d];
  for (int d = 0; d < 6; ++d) g.sc[d] = v[15 + d];
  for (int d = 0; d < 4; ++d) g.sm[d] = v[21 + d];
  g.trans_b = static_cast<int>(v[25]);
  g.mode = static_cast<int>(v[26]);
  g.has_mask = static_cast<int>(v[27]);
  if (g.nb < 1 || g.mode < 0 || g.mode > 2 || (g.has_mask && mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nsub = (g.nb + BM - 1) / BM;
  const long long blocks = g.R * g.Q * g.I * g.J * nsub * nsub;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tile_gemm_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(mask), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tile_gemm_geom_len() { return kGeom; }

extern "C" int tile_gemm_f32(const void* a, const void* b, void* c, const void* mask,
                             const long long* geom, void* stream) {
  return launch<float>(a, b, c, mask, geom, stream);
}

extern "C" int tile_gemm_f64(const void* a, const void* b, void* c, const void* mask,
                             const long long* geom, void* stream) {
  return launch<double>(a, b, c, mask, geom, stream);
}
