// ft_summa_update.cu -- one step of the checksum-carrying (ABFT) SUMMA over the
// local tile stacks of a virtual (p, q) mesh, for Hopper (sm_90a).
//
// Replaces slate_tpu/ops/pallas_ops.py:819 ft_summa_update_pallas (its
// pallas_call at :858), the consume step of slate_tpu/ft/abft.py's
// _ft_summa_jit under Option.PanelImpl pallas.  Wrapper:
// slate_tpu_torch/ops/kernels.py ft_summa_update (twin: ft_summa_update_plain).
//
// What it computes, for every grid device (r, c), in place:
//   acc[r,c,i,j]  += pan[r,c,i] @ urow[r,c,j]                         (i < I, j < J)
//   part[r,c,s,j] += sum_i w_s[r,c,i] * (pan[r,c,i] @ urow[r,c,j])     (s = 0, 1)
// with nb x nb tiles (K = nb).  w_0 / w_1 are the unit / ramp Huang-Abraham
// weights of each local tile row (zero on checksum and pad rows), so part
// gathers the device's share of the recomputed checksum rows in the same pass
// over the products: the discrepancy check needs no second sweep.  All
// operands are strided views (element strides per dim, 0 for an operand shared
// along a dim): the broadcast panels are read by every mesh column / row
// through stride 0, with no copies.
//
// What bounds it on this card: operations.  Each live tile product costs
// 2 nb^3 flops (3.4e7 at nb = 256) against ~3 nb^2 elements moved; at the
// f32 n = 16384 gemm_ft step ((2, 4, 34, 17) tiles of 256) that is 1.55e11
// flops, 2.3 ms at the 67 TFLOP/s f32 FFMA peak, against 2.4 GB of acc read +
// written (0.7 ms at 3.35 TB/s).  The weighted sums add 4 flops per output
// element, nb^2 per tile: 1/nb of the products.
//
// Design (simple and right first).  The Pallas kernel runs a (J, I) grid in
// order and carries the partial sums across the sequential i axis in VMEM
// scratch; CTAs on this card run in no order, so that carry is not ported.
// Instead one CTA of 256 threads owns one 64 x 64 block of one (r, c, j)
// output column of tiles and loops over i = 0 .. I-1 in order: for each i it
// computes the block of pan[i] @ urow[j] into registers (16-deep k-chunks of
// both operands staged through shared memory, 4 x 4 outputs per thread, one
// FMA per product in k order -- FFMA / DFMA, no TF32, as the Pallas kernel
// runs precision=HIGHEST), adds it to acc[i, j], and adds w_0[i] * upd and
// w_1[i] * upd to two more 4 x 4 register accumulators (a rounded multiply,
// then a rounded add, as the Pallas kernel's wu = w * upd; psum += wu).  After
// the loop it adds the two accumulators to part[:, j].  No atomics: every
// element's sums run in a fixed order, so results are deterministic and the
// same at every lookahead depth.  At the f32 n = 16384 step that is
// 2 * 4 * 17 * 16 = 2,176 CTAs, enough to fill 132 SMs.  Register cost: three
// 4 x 4 accumulators per thread (48 KB per CTA in f32, 96 KB in f64), inside
// the 255-register limit; `nvcc -Xptxas -v` reports the count.  What it
// leaves on the table: the tensor cores (wgmma), TMA and a multi-stage
// pipeline, keeping urow[j]'s 64-column slab in shared memory across the i
// loop (it is re-read from L2 for every i), and register blocking beyond 4 x 4.
//
// C interface (ctypes): ft_summa_update_f32 / ft_summa_update_f64(pan, urow,
// acc, w1, w2, part, geom, stream); geom points to 33 int64 host values
//   R, Q, I, J, nb, sp[5] (pan: r, q, i, row, col), su[5] (urow: r, q, j, row,
//   col), sa[6] (acc: r, q, i, j, row, col), sw1[3] (r, q, i), sw2[3],
//   spart[6] (part: r, q, s, j, row, col).
// Returns cudaGetLastError() after the launch (0 on success).  No
// synchronisation, no allocation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;             // output sub-block per CTA
constexpr int BK = 16;             // k-chunk through shared memory
constexpr int TM = 4;              // outputs per thread per dim
constexpr int TD = BM / TM;        // 16 threads per dim
constexpr int kThreads = TD * TD;  // 256
constexpr int kGeom = 33;

struct Geom {
  int64_t R, Q, I, J, nb;
  int64_t sp[5];
  int64_t su[5];
  int64_t sa[6];
  int64_t sw1[3];
  int64_t sw2[3];
  int64_t spart[6];
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ft_summa_update_kernel(const T* __restrict__ P, const T* __restrict__ U, T* A,
                       const T* __restrict__ W1, const T* __restrict__ W2, T* S, Geom g) {
  const int64_t nsub = (g.nb + BM - 1) / BM;
  int64_t t = blockIdx.x;
  const int64_t sub = t % (nsub * nsub);
  t /= nsub * nsub;
  const int64_t j = t % g.J;
  t /= g.J;
  const int64_t q = t % g.Q;
  const int64_t r = t / g.Q;

  const int64_t m0 = (sub / nsub) * BM, n0 = (sub % nsub) * BM;
  const T* u = U + r * g.su[0] + q * g.su[1] + j * g.su[2];
  const T* w1 = W1 + r * g.sw1[0] + q * g.sw1[1];
  const T* w2 = W2 + r * g.sw2[0] + q * g.sw2[1];

  __shared__ T Ps[BK][BM + 1];  // Ps[k][m] = pan[i](m0 + m, k0 + k)
  __shared__ T Us[BK][BM + 1];  // Us[k][n] = urow[j](k0 + k, n0 + n)
  const int tid = threadIdx.x;
  const int tx = tid % TD, ty = tid / TD;

  T s1[TM][TM], s2[TM][TM];
#pragma unroll
  for (int x = 0; x < TM; ++x)
#pragma unroll
    for (int y = 0; y < TM; ++y) s1[x][y] = s2[x][y] = T(0);

  for (int64_t i = 0; i < g.I; ++i) {
    const T* p = P + r * g.sp[0] + q * g.sp[1] + i * g.sp[2];
    T upd[TM][TM];
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TM; ++y) upd[x][y] = T(0);

    for (int64_t k0 = 0; k0 < g.nb; k0 += BK) {
#pragma unroll
      for (int s = 0; s < BM * BK / kThreads; ++s) {
        const int e = tid + s * kThreads;
        // pan: neighbouring threads on neighbouring k (a tile row is contiguous)
        const int pm = e / BK, pk = e % BK;
        const int64_t gm = m0 + pm, gk = k0 + pk;
        Ps[pk][pm] = (gm < g.nb && gk < g.nb) ? p[gm * g.sp[3] + gk * g.sp[4]] : T(0);
        // urow: neighbouring threads on neighbouring columns
        const int uk = e / BM, un = e % BM;
        const int64_t hk = k0 + uk, hn = n0 + un;
        Us[uk][un] = (hk < g.nb && hn < g.nb) ? u[hk * g.su[3] + hn * g.su[4]] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        T av[TM], bv[TM];
#pragma unroll
        for (int x = 0; x < TM; ++x) {
          av[x] = Ps[kk][ty + TD * x];
          bv[x] = Us[kk][tx + TD * x];
        }
#pragma unroll
        for (int x = 0; x < TM; ++x)
#pragma unroll
          for (int y = 0; y < TM; ++y) upd[x][y] = fma_rn(av[x], bv[y], upd[x][y]);
      }
      __syncthreads();
    }

    const T wi1 = w1[i * g.sw1[2]], wi2 = w2[i * g.sw2[2]];
    T* a = A + r * g.sa[0] + q * g.sa[1] + i * g.sa[2] + j * g.sa[3];
#pragma unroll
    for (int x = 0; x < TM; ++x) {
      const int64_t gm = m0 + ty + TD * x;
#pragma unroll
      for (int y = 0; y < TM; ++y) {
        const int64_t gn = n0 + tx + TD * y;
        if (gm < g.nb && gn < g.nb) {
          T* out = a + gm * g.sa[4] + gn * g.sa[5];
          *out = add_rn(*out, upd[x][y]);
        }
        s1[x][y] = add_rn(s1[x][y], mul_rn(wi1, upd[x][y]));
        s2[x][y] = add_rn(s2[x][y], mul_rn(wi2, upd[x][y]));
      }
    }
  }

  T* s0 = S + r * g.spart[0] + q * g.spart[1] + j * g.spart[3];
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int64_t gm = m0 + ty + TD * x;
    if (gm >= g.nb) continue;
#pragma unroll
    for (int y = 0; y < TM; ++y) {
      const int64_t gn = n0 + tx + TD * y;
      if (gn >= g.nb) continue;
      T* o1 = s0 + gm * g.spart[4] + gn * g.spart[5];
      T* o2 = o1 + g.spart[2];
      *o1 = add_rn(*o1, s1[x][y]);
      *o2 = add_rn(*o2, s2[x][y]);
    }
  }
}

template <typename T>
int launch(const void* pan, const void* urow, void* acc, const void* w1, const void* w2,
           void* part, const long long* geom, void* stream) {
  Geom g;
  const long long* v = geom;
  g.R = v[0]; g.Q = v[1]; g.I = v[2]; g.J = v[3]; g.nb = v[4];
  for (int d = 0; d < 5; ++d) g.sp[d] = v[5 + d];
  for (int d = 0; d < 5; ++d) g.su[d] = v[10 + d];
  for (int d = 0; d < 6; ++d) g.sa[d] = v[15 + d];
  for (int d = 0; d < 3; ++d) g.sw1[d] = v[21 + d];
  for (int d = 0; d < 3; ++d) g.sw2[d] = v[24 + d];
  for (int d = 0; d < 6; ++d) g.spart[d] = v[27 + d];
  if (g.nb < 1 || g.I < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nsub = (g.nb + BM - 1) / BM;
  const long long blocks = g.R * g.Q * g.J * nsub * nsub;
  if (blocks == 0 || g.I == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ft_summa_update_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pan), static_cast<const T*>(urow), static_cast<T*>(acc),
      static_cast<const T*>(w1), static_cast<const T*>(w2), static_cast<T*>(part), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ft_summa_update_geom_len() { return kGeom; }

extern "C" int ft_summa_update_f32(const void* pan, const void* urow, void* acc, const void* w1,
                                   const void* w2, void* part, const long long* geom,
                                   void* stream) {
  return launch<float>(pan, urow, acc, w1, w2, part, geom, stream);
}

extern "C" int ft_summa_update_f64(const void* pan, const void* urow, void* acc, const void* w1,
                                   const void* w2, void* part, const long long* geom,
                                   void* stream) {
  return launch<double>(pan, urow, acc, w1, w2, part, geom, stream);
}
