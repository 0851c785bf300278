// tile_gemm.cu -- batched, masked per-tile GEMM over the local tile stacks of
// a virtual (p, q) mesh, for Hopper (sm_90a), on the shared mainloop of
// tile_mma.cuh.
//
// One source for these TPU kernels of slate_tpu/ops/pallas_ops.py:
//   :711 summa_update_pallas          acc[i, j] += pan[i] @ urow[j]          (mode add, N)
//   :738 chol_trailing_update_pallas  view[i, j] -= mask[i, j] ? pan[i] @ pan_t[j]^T : 0
//                                                                           (mode sub, T, mask)
//   :777 lu_trailing_update_pallas    view[i, j] -= mask[i, j] ? pan[i] @ urow[j] : 0
//                                                                           (mode sub, N, mask)
//   the A_i . X solve halves of :491 chol_panel_tiles_pallas (s[i] = A_i L^-T: mode set,
//   T, B shared), :543 lu_panel_tiles_pallas (A_i U^-1: set, N, B shared) and :590
//   lu_rowsolve_tiles_pallas (L^-1 A_j: set, N, A shared).
// Wrappers: slate_tpu_torch/ops/kernels.py (_tile_gemm and its callers).
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
// nb^3 flops per tile; this kernel spends 2 nb^3 on the dense form.
//
// Design: one CTA computes one BM x BN block of one output tile with
// tile_mma::run (f32: 128 x 128 on 256 threads, 8 x 8 FFMA accumulators a
// thread, two CTAs an SM, a three-stage cp.async ring; f64: 64 x 64 on 128
// threads, m16n8k16 DMMA, four CTAs an SM, a two-stage ring; 16-byte shared
// reads: the header's note), then applies the mode once (the twin's acc + upd, the
// Pallas kernel's a_ref - sel).  One kernel per dtype and B form (N: op(B) =
// B, n contiguous; T: op(B) = B^T, k contiguous); the mode and the load
// forms are uniform runtime values.  A masked tile's CTAs return before
// reading anything, so the update is in place, the masked half of the
// Cholesky window costs only empty CTAs, and a NaN in a masked tile stays
// exactly as it was.  The element order of every sum is the header's (k in
// order, a fixed block per dtype), so a column refreshed alone (the
// lookahead narrow update, J = 1) gets the bits of the full update.
//
// nvcc 12.9 -Xptxas -v (sm_90a): 128 registers in each dtype and form, no
// spill; 60 KB (f32, three stages) / 40 KB (f64, two stages) of dynamic
// shared memory and 64 bytes of static (the operand descriptor).  The build
// keeps the log beside the library (slate_tpu_torch/_build/tile_gemm-<hash>.log)
// and chip_smoke.py prints it and fails on a spill.  What it leaves on the
// table: wgmma (an f32 product on the tensor cores is TF32, a precision
// change), TMA, and persistent CTAs over the masked grid.
//
// C interface (ctypes): tile_gemm_f32 / tile_gemm_f64(a, b, c, mask, geom,
// stream); geom points to 30 int64 host values
//   R, Q, I, J, nb, sa[5] (r, q, i, row, col), sb[5] (r, q, j, row, col),
//   sc[6] (r, q, i, j, row, col), sm[4] (r, q, i, j), trans_b, mode, has_mask,
//   vec_a, vec_b
// (mode 0: C = AB, 1: C += AB, 2: C -= AB; mask is int32, ignored when
// has_mask is 0; vec_a / vec_b: the operand may be loaded 16 bytes at a time,
// the wrapper's predicate).  Returns the first CUDA error of setting the
// shared-memory limit or of the launch (0 on success).  No synchronisation,
// no allocation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int kGeom = 30;

struct Geom {
  int64_t R, Q, I, J, nb;
  int64_t sa[5];
  int64_t sb[5];
  int64_t sc[6];
  int64_t sm[4];
  int trans_b, mode, has_mask, vec_a, vec_b;
};

template <typename T>
using Blk = tile_mma::Cfg<T, tile_mma::kGemmBN<T>>;

// sub-blocks of an nb-wide tile edge
__host__ __device__ inline int nsub(int64_t nb, int blk) {
  return static_cast<int>((nb + blk - 1) / blk);
}

template <typename T, bool BT>
__global__ void __launch_bounds__(Blk<T>::kThreads, Blk<T>::kMinCtas)
tile_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* C,
                 const int* __restrict__ M, Geom g) {
  using Cf = Blk<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sm_ = nsub(g.nb, Cf::kBM), sn = nsub(g.nb, Cf::kBN);
  int64_t t = blockIdx.x;
  const int sub = static_cast<int>(t % (sm_ * sn));
  t /= sm_ * sn;
  const int64_t j = t % g.J;
  t /= g.J;
  const int64_t i = t % g.I;
  t /= g.I;
  const int64_t q = t % g.Q;
  const int64_t r = t / g.Q;
  if (g.has_mask && M[r * g.sm[0] + q * g.sm[1] + i * g.sm[2] + j * g.sm[3]] == 0) return;

  const int nb = static_cast<int>(g.nb);
  const int m0 = (sub / sn) * Cf::kBM, n0 = (sub % sn) * Cf::kBN;
  // operands and output in shared memory, read where they are used: held
  // in registers across the mainloop they cost the f32 form its 2 CTAs/SM
  __shared__ tile_mma::Desc<T> desc;
  __shared__ T* out_tile;
  if (threadIdx.x == 0) {
    desc = {A + r * g.sa[0] + q * g.sa[1] + i * g.sa[2], 0, g.sa[3], g.sa[4],
            B + r * g.sb[0] + q * g.sb[1] + j * g.sb[2], g.sb[3], g.sb[4], g.vec_a, g.vec_b};
    out_tile = C + r * g.sc[0] + q * g.sc[1] + i * g.sc[2] + j * g.sc[3];
  }
  __syncthreads();

  tile_mma::run<Cf, BT, Cf::kStages, false>(
      reinterpret_cast<T*>(smem_raw), desc, nb, m0, n0, 1,
      [&](int, T(&acc)[Cf::kAcc], const tile_mma::Frag<Cf, BT>& f) {
        T* c = out_tile;
        const int64_t cr = g.sc[4], cc = g.sc[5];
#pragma unroll
        for (int e = 0; e < Cf::kAcc; ++e) {
          const int gm = m0 + f.row(e), gn = n0 + f.col(e);
          if (gm < nb && gn < nb) {
            T* out = c + gm * cr + gn * cc;
            *out = g.mode == 0 ? acc[e] : (g.mode == 1 ? *out + acc[e] : *out - acc[e]);
          }
        }
      });
}

template <typename T, bool BT>
int launch_form(const T* a, const T* b, T* c, const int* mask, const Geom& g, long long blocks,
                cudaStream_t stream) {
  using Cf = Blk<T>;
  constexpr size_t smem = tile_mma::ring_bytes<Cf>(Cf::kStages);
  cudaError_t err = tile_mma::allow_smem<tile_gemm_kernel<T, BT>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_gemm_kernel<T, BT><<<static_cast<unsigned>(blocks), Cf::kThreads, smem, stream>>>(
      a, b, c, mask, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, void* c, const void* mask, const long long* geom,
           void* stream) {
  using Cf = Blk<T>;
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
  g.vec_a = static_cast<int>(v[28]);
  g.vec_b = static_cast<int>(v[29]);
  if (g.nb < 1 || g.nb > 0x7fffffffLL || g.mode < 0 || g.mode > 2 ||
      (g.has_mask && mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      g.R * g.Q * g.I * g.J * nsub(g.nb, Cf::kBM) * static_cast<long long>(nsub(g.nb, Cf::kBN));
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  const int* pm = static_cast<const int*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g.trans_b ? launch_form<T, true>(pa, pb, pc, pm, g, blocks, s)
                   : launch_form<T, false>(pa, pb, pc, pm, g, blocks, s);
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
