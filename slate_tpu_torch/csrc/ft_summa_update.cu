// ft_summa_update.cu -- one step of the checksum-carrying (ABFT) SUMMA over the
// local tile stacks of a virtual (p, q) mesh, for Hopper (sm_90a), on the
// shared mainloop of tile_mma.cuh.
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
// Design.  The Pallas kernel runs a (J, I) grid in order and carries the
// partial sums across the sequential i axis in VMEM scratch; CTAs on this card
// run in no order, so one CTA owns one BM x BN block of one (r, c, j) output
// column of tiles and loops over i = 0 .. I-1 in order, with tile_mma::run
// streaming the I products as one sequence of k-chunks (the header's note).
// After product i it adds upd to acc[i, j] and w_s[i] * upd to s_s (a
// rounded multiply, then a rounded add, as the Pallas kernel's wu = w * upd;
// psum += wu), while product i + 1's first chunks are already in flight;
// after the loop it adds s_0 and s_1 to part[:, j].  No atomics: every
// element's sums run in a fixed order, so results are deterministic and the
// same at every lookahead depth.  s_0 and s_1 live in shared memory, each
// thread's own elements at [e * threads + tid] (no bank conflict, no
// barrier): three 8 x 8 f32 register sets would need 192 registers.  They
// take 2 BM BN elements, so the block is narrower than tile_gemm's in f32:
// 128 x 64 (8 x 4 FFMA accumulators a thread; 45 KB of ring + 64 KB of sums,
// two CTAs an SM, faster on an H100 than 128 x 128 at one); f64 64 x 64 on m16n8k16
// DMMA with a two-stage ring (40 KB + 64 KB, two CTAs).  urow[j]'s K x BN
// slab is re-read from L2 for every i (keeping it resident would take the
// room of the sums).  CTAs: 2 * 4 * 17 * 8 = 1,088 at the f32 step, 2 * 4 *
// 9 * 16 = 1,152 at the f64 one.  nvcc 12.9 -Xptxas -v (sm_90a): 128 (f32)
// / 184 (f64) registers, no spill (chip_smoke.py prints it from the build
// log and fails on a spill).
//
// C interface (ctypes): ft_summa_update_f32 / ft_summa_update_f64(pan, urow,
// acc, w1, w2, part, geom, stream); geom points to 35 int64 host values
//   R, Q, I, J, nb, sp[5] (pan: r, q, i, row, col), su[5] (urow: r, q, j, row,
//   col), sa[6] (acc: r, q, i, j, row, col), sw1[3] (r, q, i), sw2[3],
//   spart[6] (part: r, q, s, j, row, col), vec_p, vec_u
// (vec_p / vec_u: pan / urow may be loaded 16 bytes at a time, the wrapper's
// predicate).  Returns the first CUDA error of setting the shared-memory
// limit or of the launch (0 on success).  No synchronisation, no allocation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int kGeom = 35;

struct Geom {
  int64_t R, Q, I, J, nb;
  int64_t sp[5];
  int64_t su[5];
  int64_t sa[6];
  int64_t sw1[3];
  int64_t sw2[3];
  int64_t spart[6];
  int vec_p, vec_u;
};

__host__ __device__ inline int nsub(int64_t nb, int blk) {
  return static_cast<int>((nb + blk - 1) / blk);
}

// The block: f32 128 x 64 (kFtBN), so the two running sums (64 KB) and a
// three-stage ring (45 KB) leave room for two CTAs on an SM; f64 64 x 64
// with a two-stage ring (40 KB + 64 KB of sums, two CTAs; three stages and
// one CTA ran slower).
template <typename T>
struct Ft {
  using Blk = tile_mma::Cfg<T, tile_mma::kFtBN>;
  static constexpr int kStages = Blk::kStages;
  static constexpr size_t kSmem =
      tile_mma::ring_bytes<Blk>(kStages) + 2 * sizeof(T) * Blk::kAcc * Blk::kThreads;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(Ft<T>::Blk::kThreads, 2)
ft_summa_update_kernel(const T* __restrict__ P, const T* __restrict__ U, T* A,
                       const T* __restrict__ W1, const T* __restrict__ W2, T* S, Geom g) {
  using Cf = typename Ft<T>::Blk;
  constexpr int NT = Cf::kThreads, NA = Cf::kAcc, ST = Ft<T>::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  // s_0 at [e NT + tid], s_1 at [(NA + e) NT + tid]
  T* sums = ring + ST * tile_mma::Lay<Cf>::kStage;
  const int sm_ = nsub(g.nb, Cf::kBM), sn = nsub(g.nb, Cf::kBN);
  int64_t t = blockIdx.x;
  const int sub = static_cast<int>(t % (sm_ * sn));
  t /= sm_ * sn;
  const int64_t j = t % g.J;
  t /= g.J;
  const int64_t q = t % g.Q;
  const int64_t r = t / g.Q;

  const int nb = static_cast<int>(g.nb);
  const int m0 = (sub / sn) * Cf::kBM, n0 = (sub % sn) * Cf::kBN;
  // operands and outputs in shared memory, read where they are used (the
  // registers go to the products)
  __shared__ tile_mma::Desc<T> desc;
  __shared__ T* outs[2];  // acc[r, c, 0, j], part[r, c, 0, j]
  __shared__ const T* ws[2];
  if (threadIdx.x == 0) {
    desc = {P + r * g.sp[0] + q * g.sp[1], g.sp[2], g.sp[3], g.sp[4],
            U + r * g.su[0] + q * g.su[1] + j * g.su[2], g.su[3], g.su[4], g.vec_p, g.vec_u};
    outs[0] = A + r * g.sa[0] + q * g.sa[1] + j * g.sa[3];
    outs[1] = S + r * g.spart[0] + q * g.spart[1] + j * g.spart[3];
    ws[0] = W1 + r * g.sw1[0] + q * g.sw1[1];
    ws[1] = W2 + r * g.sw2[0] + q * g.sw2[1];
  }
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 2 * NA; ++e) sums[e * NT + tid] = T(0);
  __syncthreads();

  tile_mma::run<Cf, false, ST, true>(
      ring, desc, nb, m0, n0, static_cast<int>(g.I),
      [&](int i, T(&upd)[NA], const tile_mma::Frag<Cf, false>& f) {
        const T wi1 = ws[0][i * g.sw1[2]], wi2 = ws[1][i * g.sw2[2]];
        T* a = outs[0] + i * g.sa[2];
        const int64_t ar = g.sa[4], ac = g.sa[5];
        // three passes with compiler barriers between them: in one, the
        // loads of acc and both sums were all in flight together and the
        // f32 form spilled at the 128-register bound
#pragma unroll
        for (int e = 0; e < NA; ++e) {
          const int gm = m0 + f.row(e), gn = n0 + f.col(e);
          if (gm < nb && gn < nb) {
            T* out = a + gm * ar + gn * ac;
            *out = add_rn(*out, upd[e]);
          }
        }
        asm volatile("" ::: "memory");
#pragma unroll
        for (int e = 0; e < NA; ++e)
          sums[e * NT + tid] = add_rn(sums[e * NT + tid], mul_rn(wi1, upd[e]));
        asm volatile("" ::: "memory");
#pragma unroll
        for (int e = 0; e < NA; ++e)
          sums[(NA + e) * NT + tid] = add_rn(sums[(NA + e) * NT + tid], mul_rn(wi2, upd[e]));
      });

  const tile_mma::Frag<Cf, false> f;
  T* part = outs[1];
#pragma unroll
  for (int e = 0; e < NA; ++e) {
    const int gm = m0 + f.row(e), gn = n0 + f.col(e);
    if (gm >= nb || gn >= nb) continue;
    T* o1 = part + gm * g.spart[4] + gn * g.spart[5];
    T* o2 = o1 + g.spart[2];
    *o1 = add_rn(*o1, sums[e * NT + tid]);
    *o2 = add_rn(*o2, sums[(NA + e) * NT + tid]);
  }
}

template <typename T>
int launch(const void* pan, const void* urow, void* acc, const void* w1, const void* w2,
           void* part, const long long* geom, void* stream) {
  using Cf = typename Ft<T>::Blk;
  Geom g;
  const long long* v = geom;
  g.R = v[0]; g.Q = v[1]; g.I = v[2]; g.J = v[3]; g.nb = v[4];
  for (int d = 0; d < 5; ++d) g.sp[d] = v[5 + d];
  for (int d = 0; d < 5; ++d) g.su[d] = v[10 + d];
  for (int d = 0; d < 6; ++d) g.sa[d] = v[15 + d];
  for (int d = 0; d < 3; ++d) g.sw1[d] = v[21 + d];
  for (int d = 0; d < 3; ++d) g.sw2[d] = v[24 + d];
  for (int d = 0; d < 6; ++d) g.spart[d] = v[27 + d];
  g.vec_p = static_cast<int>(v[33]);
  g.vec_u = static_cast<int>(v[34]);
  if (g.nb < 1 || g.nb > 0x7fffffffLL || g.I < 0 || g.I > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      g.R * g.Q * g.J * nsub(g.nb, Cf::kBM) * static_cast<long long>(nsub(g.nb, Cf::kBN));
  if (blocks == 0 || g.I == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = Ft<T>::kSmem;
  cudaError_t err = tile_mma::allow_smem<ft_summa_update_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ft_summa_update_kernel<T><<<static_cast<unsigned>(blocks), Cf::kThreads, smem,
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
