// tile_mma.cuh -- the mainloop shared by tile_gemm.cu and ft_summa_update.cu:
// one CTA computes a BM x BN block of A . op(B) over one nb x nb tile pair
// (K = nb), into registers, on Hopper (sm_90a).
//
// What the callers need from it.  Every mesh tile update of the port is a
// batch of nb x nb products over strided views: A[r,q,i] (k contiguous in
// every caller; a tile stack, or one shared block read through stride 0) and
// op(B)[r,q,j], which is n contiguous in the N form (summa_update,
// lu_trailing_update, the panel solves, ft_summa_update) and k contiguous in
// the T form (chol_trailing_update's pan_t[j]^T, chol_panel_tiles' L^-T).
// The caller picks the tile, applies the mode and handles masks (a masked
// CTA returns before it calls the core).
//
// What bounds the work: operations (2 nb^3 flops a tile against 3 nb^2
// elements moved), at 67 TFLOP/s f32 outside the tensor cores and 67 TFLOP/s
// f64 on the FP64 tensor cores.  What keeps a kernel from them is shared
// memory per FMA and occupancy, so the design:
//   * f32: 128 x 128 outputs per CTA of 256 threads (ft_summa_update: 128 x
//     64), 8 x 8 (8 x 4) per thread, plain IEEE FFMA (no TF32: the Pallas
//     kernels run precision=HIGHEST).  N form: per k pair, a thread reads its
//     8 rows of A as 8-byte broadcasts and per k its columns of op(B) as
//     16-byte reads; T form: per 4-deep k step, 4 columns of B as 16-byte
//     reads, then each row of A as a 16-byte broadcast.  A quarter-warp (the
//     8 lanes one 16-byte read serves at a time) shares its A rows; its op(B)
//     reads are 8 consecutive 16-byte chunks (N) or 8 rows of an 80-byte
//     stride (T: row l on banks 20 l mod 32 .. +3, distinct for l < 8): no
//     bank conflicts.  ~9% of the instructions are shared loads.
//   * f64: 64 x 64 outputs per CTA of 128 threads (2 x 2 warps of 32 x 32)
//     on mma.sync m16n8k16 f64 (DMMA), 2 x 4 of them a warp per chunk.  Row
//     strides of 20 (k-contiguous) and 68 (n-contiguous) doubles put the 16
//     lanes one 8-byte read serves on distinct banks.  The narrower block
//     keeps the accumulators at 64 registers and gives the smallest launch
//     (the f64 ladder's (2,4,32,1) residual) 4,096 CTAs.
//   * Occupancy: launch bounds of 2 CTAs an SM in f32 and 4 in f64 (128
//     registers a thread either way); the registers go to the products.  Three things
//     make that fit with no spill: the operands' pointers and strides live
//     in shared memory (Desc), read once a chunk; the copies recompute their
//     indices from an opaque thread index each chunk instead of holding ~30
//     of them; the T form's k loop is not unrolled.  Each was measured: see
//     the comments at those places and PERF.md.
//   * A ring of kStages shared-memory stages fed by cp.async (three in f32,
//     two in f64, where a fourth CTA an SM hides more latency than a third
//     stage): the loads of chunk c + kStages - 1 are issued before chunk c's
//     products; one barrier per chunk.
//     A load copies 16 bytes (cp.async.cg) where the wrapper found the
//     operand 16-byte loadable -- its contiguous index has stride 1, every
//     other stride a multiple of 16 bytes, a 16-byte aligned base and nb a
//     multiple of the vector -- and one element (cp.async.ca, 4 or 8 bytes)
//     otherwise.  The wrapper decides once per launch and per operand (a pure
//     function of strides, data_ptr() and nb); the branch is uniform and
//     lies outside the products.  Off the tile (row, column or k >= nb) the
//     copy zero-fills, so any nb >= 1 works: a zero row or column of the
//     padding meets only zeros of the other operand or outputs that are not
//     stored, and a NaN of a real entry reaches only the outputs its row and
//     column reach in the plain product.
//   * Several output blocks in one pass: run() streams count blocks (ft:
//     the tile rows i = 0 .. I-1 of one output column) as one sequence of
//     k-chunks, calling the epilogue after each block's last chunk while the
//     next block's chunks are already in flight.
//
// Summation order, the invariant the lookahead and bitwise tests rest on:
// each output element's sum runs k = 0, 1, ..., nb-1 in order, one FFMA per
// product (f32), or one m16n8k16 DMMA per 16-deep k step in order (f64).  The
// block shape is fixed per kernel and dtype, there is no split-k and no
// atomic, so an element gets the same bits whatever the launch's grid, I, J
// or mask; the caller applies its mode (=, +=, -=) once, after the sum.
//
// Registers, spills and shared memory of each kernel (nvcc -Xptxas -v): the
// notes of tile_gemm.cu and ft_summa_update.cu.

#pragma once

#include <atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_mma {

// A CTA's block: BM x BN outputs of one tile, k-chunks of BK, kThreads
// threads; tile_gemm launches Cfg<T, kGemmBN<T>>, ft_summa_update
// Cfg<T, kFtBN> (a narrower f32 block, so its two running sums fit beside
// the ring: see ft_summa_update.cu).
template <typename T, int BN>
struct Cfg;

template <int BN>
struct Cfg<float, BN> {
  static_assert(BN == 128 || BN == 64, "8 or 4 columns a thread");
  using Elem = float;
  static constexpr int kBM = 128, kBN = BN, kBK = 16;
  static constexpr int kThreads = 256;
  static constexpr int kMinCtas = 2;  // launch bound: <= 128 registers a thread
  // three stages of 16: four, or 32-deep chunks in two or three stages,
  // moved the updates by a few percent either way on an H100 and pushed
  // ft_summa_update to one CTA an SM or a spill
  static constexpr int kStages = 3;
  static constexpr int kTN = BN / 16;  // columns a thread
  static constexpr int kAcc = 8 * kTN;  // 8 x kTN outputs a thread
  static constexpr int kMmaK = 1;  // one FFMA per product
};

template <>
struct Cfg<double, 64> {
  using Elem = double;
  static constexpr int kBM = 64, kBN = 64, kBK = 16;
  static constexpr int kThreads = 128;
  // four CTAs an SM (<= 128 registers, 4 x 40 KB of ring) ran faster on an
  // H100 than three with a three-stage ring; five spill
  static constexpr int kMinCtas = 4;
  static constexpr int kStages = 2;
  static constexpr int kAcc = 32;  // 2 x 4 m16n8 tiles, 4 outputs each
  static constexpr int kMmaK = 16;  // k depth of one m16n8k16 DMMA
};

template <typename T>
constexpr int kGemmBN = sizeof(T) == 4 ? 128 : 64;
constexpr int kFtBN = 64;

// Shared-memory layout of one stage: the A slab As[m][k] (BM rows of kLdK),
// then the op(B) slab, Bs[k][n] (BK rows of kLdN) in the N form or Bs[n][k]
// (BN rows of kLdK) in the T form.  Every row stride is a multiple of 16
// bytes, so 16-byte copies land aligned.
template <class C>
struct Lay {
  using T = typename C::Elem;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLdK = C::kBK + 4;
  static constexpr int kLdN = C::kBN + (sizeof(T) == 8 ? 4 : 0);
  static constexpr int kA = C::kBM * kLdK;
  static constexpr int kB = C::kBN * kLdK > C::kBK * kLdN ? C::kBN * kLdK : C::kBK * kLdN;
  static constexpr int kStage = kA + kB;
};

template <class C>
constexpr size_t ring_bytes(int stages) {
  return static_cast<size_t>(stages) * Lay<C>::kStage * sizeof(typename C::Elem);
}

// Lift a kernel's dynamic shared-memory limit above the default 48 KB (a
// launch past it is refused), once per device and instantiation; a failed
// call is made again at the next launch.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kDevices = 64;
  static std::atomic<bool> done[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void cp_elem(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int nbytes = ok ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(nbytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(nbytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_vec(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v, as a value the compiler cannot see through: indices computed from it
// are recomputed where they are used instead of being hoisted out of the
// mainloop and held.  The copies' ~30 indices, held, spilled at the
// 128-register bound.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("mov.b32 %0, %0;" : "+r"(v));
  return v;
}

// ---------------------------------------------------------------------------
// slab loads: ROWS x BK with k contiguous in shared (A; op(B) in the T form),
// or BK x BN with n contiguous (op(B) in the N form)
// ---------------------------------------------------------------------------

// dst[row * kLdK + k] = m(r0 + row, k0 + k), zero off the nb x nb tile; m's
// element (row, k) lies at p + row * rs + k * ks.
template <class C, int ROWS, typename T = typename C::Elem>
__device__ __forceinline__ void load_rows(T* dst, const T* p, int64_t rs, int64_t ks, int nb,
                                          int r0, int k0, bool vec) {
  using L = Lay<C>;
  constexpr int BK = C::kBK, NT = C::kThreads;
  const int tid = opaque(static_cast<int>(threadIdx.x));  // see opaque()
  if (vec) {  // ks == 1, nb % kVec == 0: a copy is wholly on or off the tile
    constexpr int kPer = BK / L::kVec;
    static_assert(ROWS * kPer % NT == 0, "whole copies per thread");
#pragma unroll
    for (int s = 0; s < ROWS * kPer / NT; ++s) {
      const int q = tid + s * NT;
      const int row = q / kPer, k = (q % kPer) * L::kVec;
      const int gr = r0 + row, gk = k0 + k;
      const bool ok = gr < nb && gk < nb;
      cp_vec(dst + row * L::kLdK + k, ok ? p + gr * rs + gk : p, ok);
    }
  } else {  // lanes along k: coalesced where ks == 1
    static_assert(ROWS * BK % NT == 0, "whole copies per thread");
#pragma unroll
    for (int s = 0; s < ROWS * BK / NT; ++s) {
      const int q = tid + s * NT;
      const int row = q / BK, k = q % BK;
      const int gr = r0 + row, gk = k0 + k;
      const bool ok = gr < nb && gk < nb;
      cp_elem(dst + row * L::kLdK + k, ok ? p + gr * rs + gk * ks : p, ok);
    }
  }
}

// dst[k * kLdN + n] = op(B)(k0 + k, n0 + n) = p[(k0 + k) * rs + (n0 + n) * ns]
template <class C, typename T = typename C::Elem>
__device__ __forceinline__ void load_cols(T* dst, const T* p, int64_t rs, int64_t ns, int nb,
                                          int n0, int k0, bool vec) {
  using L = Lay<C>;
  constexpr int BK = C::kBK, BN = C::kBN, NT = C::kThreads;
  const int tid = opaque(static_cast<int>(threadIdx.x));
  if (vec) {  // ns == 1
    constexpr int kPer = BN / L::kVec;
    static_assert(BK * kPer % NT == 0, "whole copies per thread");
#pragma unroll
    for (int s = 0; s < BK * kPer / NT; ++s) {
      const int q = tid + s * NT;
      const int k = q / kPer, n = (q % kPer) * L::kVec;
      const int gk = k0 + k, gn = n0 + n;
      const bool ok = gk < nb && gn < nb;
      cp_vec(dst + k * L::kLdN + n, ok ? p + gk * rs + gn : p, ok);
    }
  } else {  // lanes along n
    static_assert(BK * BN % NT == 0, "whole copies per thread");
#pragma unroll
    for (int s = 0; s < BK * BN / NT; ++s) {
      const int q = tid + s * NT;
      const int k = q / BN, n = q % BN;
      const int gk = k0 + k, gn = n0 + n;
      const bool ok = gk < nb && gn < nb;
      cp_elem(dst + k * L::kLdN + n, ok ? p + gk * rs + gn * ns : p, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// the products of one k-chunk, and where each accumulator lies in the block
// ---------------------------------------------------------------------------

template <class C, bool BT, typename T = typename C::Elem>
struct Frag;

// f32: quarter-warp p = lane / 8 holds 8 consecutive tx and one ty;
// tx = lane % 8 + 8 (p % 2) in 0..15, ty = 2 warp + p / 2 in 0..15.
// Rows ty + 16 i; columns tx 4 + (0..3) and, with 8 a thread, 64 + tx 4 +
// (0..3) (N form), or tx + 16 j (T form).  acc[TN i + j].
template <class C, bool BT>
struct Frag<C, BT, float> {
  using L = Lay<C>;
  static constexpr int TN = C::kTN;
  int tx, ty;
  __device__ Frag() {
    const int lane = threadIdx.x & 31, p = lane >> 3;
    tx = (lane & 7) + ((p & 1) << 3);
    ty = ((threadIdx.x >> 5) << 1) + (p >> 1);
  }
  __device__ __forceinline__ int row(int e) const { return ty + 16 * (e / TN); }
  __device__ __forceinline__ int col(int e) const {
    return BT ? tx + 16 * (e % TN) : ((e % TN) >= 4 ? 64 : 0) + tx * 4 + (e & 3);
  }
  // N form: per k pair, A's 8 rows as 8-byte broadcasts (16 registers), then
  // per k op(B)'s TN columns as 16-byte reads.  T form: per 4-deep k step
  // and group of 4 columns, B's 4 rows as 16-byte reads (16 registers), then
  // per row of A a 16-byte broadcast.  Either way ~100 registers live, so
  // two CTAs fit an SM (launch bound 128 registers).
  __device__ __forceinline__ void mma(float (&acc)[C::kAcc], const float* As, const float* Bs) const {
    if constexpr (BT) {
      // not unrolled: unrolled, the scheduler's prefetch across k steps
      // spilled accumulators at the 128-register bound
#pragma unroll 1
      for (int kq = 0; kq < C::kBK; kq += 4) {
#pragma unroll
        for (int jh = 0; jh < TN; jh += 4) {
          float b[4][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 v = *reinterpret_cast<const float4*>(Bs + (tx + 16 * (jh + jj)) * L::kLdK + kq);
            b[jj][0] = v.x; b[jj][1] = v.y; b[jj][2] = v.z; b[jj][3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * L::kLdK + kq);
            const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                acc[TN * i + jh + jj] = __fmaf_rn(a[u], b[jj][u], acc[TN * i + jh + jj]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kp = 0; kp < C::kBK; kp += 2) {
        float a[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(As + (ty + 16 * i) * L::kLdK + kp);
          a[i][0] = v.x; a[i][1] = v.y;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* br = Bs + (kp + u) * L::kLdN + tx * 4;
          float b[TN];
#pragma unroll
          for (int h = 0; h < TN; h += 4) {
            const float4 v = *reinterpret_cast<const float4*>(br + 16 * h);
            b[h] = v.x; b[h + 1] = v.y; b[h + 2] = v.z; b[h + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[TN * i + j] = __fmaf_rn(a[i][u], b[j], acc[TN * i + j]);
        }
      }
    }
  }
};

// D = A B + D on the FP64 tensor cores, the sm_90 shape m16n8k16 (A 8, B 4,
// C 4 doubles a lane).  The sm_80 m8n8k4 ran this kernel slower on an H100.
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[8], const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// f64: warp w = 2 wm + wn owns rows 32 wm .. +31 and columns 32 wn .. +31 as
// 2 x 4 m16n8 tiles (mi, ni).  Lane 4 g + t holds A(g + 8 (r % 2), t + 4 (r / 2))
// for r < 8, B(t + 4 r, g) for r < 4 and C(g + 8 (v / 2), 2 t + v % 2) for
// v < 4 (CUTLASS's SM90_16x8x16_F64F64F64F64_TN layout).  acc[4 (4 mi + ni) + v].
template <class C, bool BT>
struct Frag<C, BT, double> {
  using L = Lay<C>;
  static_assert(C::kBK % C::kMmaK == 0 && C::kBM == 64 && C::kBN == 64, "the 64 x 64 block");
  int g, t, wm, wn;
  __device__ Frag() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    wm = warp >> 1;
    wn = warp & 1;
  }
  __device__ __forceinline__ int row(int e) const { return 32 * wm + 16 * (e >> 4) + g + 8 * ((e & 3) >> 1); }
  __device__ __forceinline__ int col(int e) const { return 32 * wn + 8 * ((e >> 2) & 3) + 2 * t + (e & 1); }
  __device__ __forceinline__ void mma(double (&acc)[32], const double* As, const double* Bs) const {
#pragma unroll
    for (int kk = 0; kk < C::kBK; kk += C::kMmaK) {
      double a[2][8], b[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          a[mi][r] = As[(32 * wm + 16 * mi + g + 8 * (r & 1)) * L::kLdK + kk + t + 4 * (r >> 1)];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          b[ni][r] = BT ? Bs[(32 * wn + 8 * ni + g) * L::kLdK + kk + t + 4 * r]
                        : Bs[(kk + t + 4 * r) * L::kLdN + 32 * wn + 8 * ni + g];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          dmma(*reinterpret_cast<double(*)[4]>(acc + 4 * (4 * mi + ni)), a[mi], b[ni]);
    }
  }
};

// ---------------------------------------------------------------------------
// the mainloop
// ---------------------------------------------------------------------------

// The operands of one CTA: A_o = a + o a_step for o = 0 .. count-1 (the ft
// kernel's tile rows i), op(B) from b; element (row, col) of a tile lies at
// p + row rs + col cs; vec is the wrapper's 16-byte predicate.  The kernel
// writes it to shared memory once and the mainloop reads it there once a
// chunk: held in registers, its 14 words pushed the f32 T form over the 128
// registers that two CTAs per SM leave a thread (ptxas spilled accumulators).
template <typename T>
struct Desc {
  const T* a;
  int64_t a_step, a_rs, a_cs;
  const T* b;
  int64_t b_rs, b_cs;
  int a_vec, b_vec;
};

// For o = 0 .. count-1 in order: acc = A_o . op(B) over the block (m0, n0),
// then epi(o, acc, frag); op(B) is B (BT false) or B^T (BT true).  `ring`
// holds STAGES stages; `d` lies in shared memory, written before a barrier.
// MULTI false takes count as 1 (tile_gemm): the only epilogue runs after the
// loop.  The last epilogue runs with no copy in flight, so the caller may
// reuse the ring after it.
template <class C, bool BT, int STAGES, bool MULTI, class Epi, typename T = typename C::Elem>
__device__ __forceinline__ void run(T* ring, const Desc<T>& d, int nb, int m0, int n0, int count,
                                    Epi epi) {
  using L = Lay<C>;
  const int nk = (nb + C::kBK - 1) / C::kBK;
  const int total = MULTI ? count * nk : nk;
  auto load = [&](int c) {
    T* st = ring + (c % STAGES) * L::kStage;
    const int o = MULTI ? c / nk : 0, k0 = (c % nk) * C::kBK;
    load_rows<C, C::kBM>(st, d.a + o * d.a_step, d.a_rs, d.a_cs, nb, m0, k0, d.a_vec);
    if constexpr (BT)
      load_rows<C, C::kBN>(st + L::kA, d.b, d.b_rs, d.b_cs, nb, n0, k0, d.b_vec);
    else
      load_cols<C>(st + L::kA, d.b, d.b_rs, d.b_cs, nb, n0, k0, d.b_vec);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_commit();  // an empty group keeps the count of wait_group right
  }
  const Frag<C, BT> frag;
  T acc[C::kAcc];
#pragma unroll
  for (int e = 0; e < C::kAcc; ++e) acc[e] = T(0);
  for (int c = 0; c < total; ++c) {
    cp_wait<STAGES - 2>();  // chunk c has landed (this thread's copies) ...
    __syncthreads();        // ... everyone's, and chunk c - 1's stage is free
    if (c + STAGES - 1 < total) load(c + STAGES - 1);
    cp_commit();
    const T* st = ring + (c % STAGES) * L::kStage;
    frag.mma(acc, st, st + L::kA);
    if (MULTI && c % nk == nk - 1 && c + 1 < total) {
      epi(c / nk, acc, frag);
#pragma unroll
      for (int e = 0; e < C::kAcc; ++e) acc[e] = T(0);
    }
  }
  cp_wait<0>();
  epi(MULTI ? count - 1 : 0, acc, frag);
}

}  // namespace tile_mma
