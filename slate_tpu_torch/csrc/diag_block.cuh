// diag_block.cuh -- the blocked machinery shared by chol_diag_inv.cu and
// lu_diag_inv.cu: one CTA of 256 threads factors or inverts one n x n
// diagonal block (n <= 256) in 32-wide panels, on Hopper (sm_90a).
//
// Why this shape.  The callers launch one block at a time on the critical
// path, so the kernel is bound by latency, not by bytes or flops (~1e7 flops,
// under a microsecond of the card's rates).  The earlier kernels ran an
// unblocked column loop over a working copy in L2: 2n block barriers, each
// column a dependent L2 round trip, and inverses whose thread c ran a chain of
// ~n^2/2 FMAs reading global memory while 3/4 of the warps idled.  Here:
//
//   * Panels of kB = 32 columns.  A step is: a register-tiled product over
//     the finished panels (every warp busy), one warp factoring the 32 x 32
//     diagonal block in registers (no block barrier inside), and the panel
//     below solved by substitution, one row per thread.  About 5 block
//     barriers per step plus one per 32-deep slab of the product, against 2n.
//   * Only the current panel lives in shared memory; the finished panels
//     stream from L2 (the outputs, written once per step) through a ring of
//     three slab stages by cp.async (16 bytes a copy where n and the
//     pointers are aligned), two slabs in flight while one is multiplied,
//     and a step's first slab prefetched during the previous step's serial
//     phases.  One f32 block (256 KB) or f64 block (512 KB) does not fit a
//     CTA's 227 KB; left-looking (Cholesky) and Crout (LU) orders never need
//     more than a panel on chip: 114.9 KB (f32) / 217.6 KB (f64) of dynamic
//     shared memory.
//   * The product is plain FFMA/DFMA in a thread's 8 x 4 register tile
//     (rows ty + 32 r, columns tx + 8 jj: conflict-free shared loads).  No
//     TF32: the factor must hold 3 nb eps |L||L^T| by reconstruction.
//   * Divisions on the pivot chain are products with a reciprocal (the same
//     inf and NaN), and the warp factors broadcast a pivot's column or row
//     through shared memory 16 bytes at a time: the pivots, not the FMAs,
//     are the chain.
//   * Inverses go by block rows: a product over the finished rows of X (the
//     structural zeros right of each slab's last row are skipped), then
//     substitution with the 32 x 32 diagonal block, one column per thread.
//     U^-1 is the same forward code on the exchange-mirrored matrix (J U J is
//     lower triangular), so one routine serves L^-1, unit-L^-1 and U^-1.
//   * Ragged n: the block is padded to npad = 32 ceil(n / 32) with the
//     identity; loads off the n x n matrix read 0, stores off it are dropped.
//     Padding never reaches a stored entry (the argument is in tri_inverse).
//
// What bounds it now: the slab products, which are shared-memory bound (a
// 32-wide panel spread over 256 threads leaves each a tile of ~3 x 4, ~0.6
// shared loads a FMA, and the SM serves 32 lanes of shared loads a cycle
// against 128 FMA lanes), then the diagonal warp's pivot chain and the slab
// copies.  What did not move it (tried on an H100, builds not kept): a
// three-stage ring against two, one barrier a slab against two, 16-byte
// shared loads, the bulk copy engine (one copy a 128-byte row: slower), a
// recursive inverse with 128-wide products (no change) and a right-looking
// factor with 8 x 8 trailing tiles in L2 (slower).  The next steps: DMMA for the f64 products, and the
// diagonal warp overlapped with the next step's product (warp
// specialisation).
//
// Semantics kept from the twins (slate_tpu's _chol_inv_body, _lu_inv_body,
// _unit_linv_body): the same divisors (sqrt(w_jj), the LU `denom` rule in
// the factor, the raw diagonal in the inverses), no clamping and no early
// exit, so a non-SPD block NaN-poisons from the bad column and a zero LU pivot
// gives inf/NaN in U^-1 only.  Sums run in another order and a division is a
// product with the divisor's reciprocal, so values agree to O(eps cond), not
// bitwise.  NaN and finite masks agree exactly for finite input blocks (a
// denormal f64 Cholesky pivot, which the reciprocal square root flushes,
// aside): see tri_inverse for the one place where the twins' full-row
// products reach entries a triangular order never forms.

#pragma once

#include <atomic>
#include <climits>
#include <cuda_runtime.h>

namespace diag_block {

constexpr int kThreads = 256;     // 8 warps
constexpr int kMaxN = 256;
constexpr int kB = 32;            // panel width, and the k depth of a slab
constexpr int kMaxRows = kMaxN - kB;  // step 0 has no product: a slab has <= 224 rows
constexpr int kLdP = kB + 1;      // panel rows: conflict-free per-thread row reads
constexpr int kPanelElems = kMaxN * kLdP;     // one panel of up to 256 rows x 32
constexpr int kDiagElems = kB * kLdP;         // a 32 x 32 diagonal block

// A slab keeps the global layout: the index contiguous in memory stays
// contiguous, so a copy can move 16 bytes (kVec elements) and never
// transposes.  An operand whose k runs along a row is stored row-major with
// stride ldr, one whose rows run along a row of memory k-major with stride
// ldk; the 16 extra bytes of a stride keep the reads of a warp (rows ty + 32 r,
// columns tx + 8 jj) on distinct banks.
template <typename T>
struct Lay {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLdr = kB + kVec;
  static constexpr int kLdk = kMaxRows + kVec;
  static constexpr int kAElems = kMaxRows * kLdr > kB * kLdk ? kMaxRows * kLdr : kB * kLdk;
  static constexpr int kStage = kAElems + kB * kLdr;
  static constexpr int kSlabElems = 3 * kStage;  // a ring of three stages
  static constexpr int kElems = kSlabElems + kDiagElems + kB;
  static_assert(kPanelElems <= kStage, "the panel lives in the third slab stage");
};

template <typename T>
constexpr size_t smem_bytes() { return static_cast<size_t>(Lay<T>::kElems) * sizeof(T); }

// The dynamic shared memory: three slab stages, one diagonal block and the 32
// reciprocals of a diagonal (217.6 KB in f64, 114.9 KB in f32).  The panel
// of a step (up to 256 rows of 32) is the third stage: it is written after a
// product and dead by the next one, and a product that runs while a panel is
// live keeps to stages 0 and 1 (Gemm::nst).
template <typename T>
struct Smem {
  T* slab;
  T* panel;
  T* diag;
  T* rcp;
  __device__ explicit Smem(unsigned char* raw)
      : slab(reinterpret_cast<T*>(raw)), panel(slab + 2 * Lay<T>::kStage),
        diag(slab + Lay<T>::kSlabElems), rcp(diag + kDiagElems) {}
};

// Lift Kernel's dynamic shared-memory limit above the default 48 KB (a
// launch past it is refused), once per device: the attribute stays set, so
// later launches make no driver call for it.  Its error is the launcher's
// return code, and a failed call is made again at the next launch.
template <typename T, auto Kernel>
cudaError_t allow_smem() {
  constexpr int kDevices = 64;
  static std::atomic<bool> done[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<T>()));
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
// The correctly rounded reciprocal.  A divisor is turned into one, off the
// dependent chain, and the dividends are multiplied by it: one more rounding
// than a division, and the same inf and NaN (1/0 = inf, x inf = inf or NaN
// as x / 0, 1/NaN = NaN, 1/inf = 0).  The division's latency on the chain is
// what the pivot loops are made of.
__device__ __forceinline__ float dev_rcp(float v) { return __frcp_rn(v); }
__device__ __forceinline__ double dev_rcp(double v) { return __drcp_rn(v); }
// 1 / sqrt(v), from v directly (so it runs beside the sqrt, not after it):
// within 2 ulp of 1 / sqrt(v), with 1/sqrt's inf and NaN (inf at 0, NaN below
// 0 or at NaN, 0 at inf).
__device__ __forceinline__ float dev_rsqrt(float v) { return rsqrtf(v); }
__device__ __forceinline__ double dev_rsqrt(double v) {
  // the hardware approximation and two Newton steps: the library's rsqrt is
  // a longer software sequence on the pivot chain (3% of the f64 kernel on
  // the H100); 0 and inf are taken apart, where a Newton step gives NaN
  double r;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(v));
  const double r1 = fma(0.5 * r, fma(-v, r * r, 1.0), r);
  const double r2 = fma(0.5 * r1, fma(-v, r1 * r1, 1.0), r1);
  return v == 0.0 ? r : (v == __longlong_as_double(0x7ff0000000000000LL) ? 0.0 : r2);
}

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// 16-byte shared-memory loads (kVec elements; p 16-byte aligned).
__device__ __forceinline__ void ld16(const float* p, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void ld16(const double* p, double (&o)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  o[0] = q.x; o[1] = q.y;
}
// 16-byte store of kVec elements (p 16-byte aligned).
__device__ __forceinline__ void st16(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void st16(double* p, const double (&o)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
}

// ---------------------------------------------------------------------------
// cp.async: one element (4 or 8 bytes) or 16 bytes per copy, zero-filled off
// the matrix
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool ok) {
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

// 16 bytes (kVec elements), zero-filled unless ok; src and dst 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Logical indices of the padded npad x npad block and where they lie in the
// n x n row-major matrix; FLIP is the exchange mirror i -> npad - 1 - i.
template <bool FLIP>
struct Geo {
  int n, npad;
  __device__ __forceinline__ int phys(int i) const { return FLIP ? npad - 1 - i : i; }
  template <typename T>
  __device__ __forceinline__ const T* at(const T* m, int i, int j) const {
    const int pi = phys(i), pj = phys(j);
    return (pi < n && pj < n) ? m + pi * n + pj : nullptr;
  }
};

// One kB-deep slab of rows [0, rows) (rows a multiple of 32) into dst.
// Element (row, kk) is the logical entry KFAST ? (r0 + row, k0 + kk)
// : (k0 + kk, r0 + row) of m, zero off the matrix, stored at
// KFAST ? dst[row * kLdr + kk] : dst[kk * ldk + row] (ldk is kLdk for an A
// slab, kLdr for the 32 columns of a B slab).  With vec every copy moves kVec
// elements that are contiguous in both places (the caller checks the
// alignment); otherwise one element, the lanes of a warp along the
// contiguous index.  No index is divided by a variable.
template <typename T, bool KFAST, bool FLIP>
__device__ __forceinline__ void load_slab(T* dst, int ldk, const T* m, Geo<FLIP> g, int r0, int k0,
                                          int rows, bool vec) {
  using L = Lay<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  // Why two paths: with the 16-byte copies (and 16-byte stores of L and X)
  // chol_diag_inv read 0.1751 / 0.2493 ms f32 / f64 at n = 256 against
  // 0.1916 / 0.2506 with one element a copy (an H100, both builds in one
  // call; PERF.md, PR 8); the panel rows moved by -3.5% to +1.9%.
  if (vec) {  // never FLIP: the caller only asks where the mirror is off
    constexpr int kPerRow = kB / L::kVec;  // copies per kB-long run
    if (KFAST) {
      for (int q = threadIdx.x; q < rows * kPerRow; q += kThreads) {
        const int row = q / kPerRow, kk = (q % kPerRow) * L::kVec;
        const T* src = g.at(m, r0 + row, k0 + kk);
        cp_async16(dst + row * L::kLdr + kk, src ? src : m, src != nullptr);
      }
    } else {
      for (int kk = warp; kk < kB; kk += kWarps) {
        for (int row = lane * L::kVec; row < rows; row += 32 * L::kVec) {
          const T* src = g.at(m, k0 + kk, r0 + row);
          cp_async16(dst + kk * ldk + row, src ? src : m, src != nullptr);
        }
      }
    }
    return;
  }
  if (KFAST) {
    for (int row = warp; row < rows; row += kWarps) {
      const T* src = g.at(m, r0 + row, k0 + lane);
      cp_async(dst + row * L::kLdr + lane, src ? src : m, src != nullptr);
    }
  } else {
    for (int kk = warp; kk < kB; kk += kWarps) {
      for (int row = lane; row < rows; row += 32) {
        const T* src = g.at(m, k0 + kk, r0 + row);
        cp_async(dst + kk * ldk + row, src ? src : m, src != nullptr);
      }
    }
  }
}

// acc[r][jj] += sum_kk A(ty + 32 r, kk) B(kk, tx + 8 jj) over the rows of the
// first HI row groups, A and B in the slab layouts of load_slab; a row-major
// operand is read kVec values of k at a time (16 bytes).  HI is a template
// argument, so acc stays in registers and no instruction is spent on rows a
// slab does not reach.
template <typename T, bool AK, bool BK, int HI>
__device__ __forceinline__ void slab_fma(T (&acc)[8][4], const T* sA, const T* sB, int ty, int tx) {
  using L = Lay<T>;
  constexpr int V = L::kVec;
#pragma unroll 2
  for (int kq = 0; kq < kB; kq += V) {
    T b[4][V], a[HI][V];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = tx + 8 * jj;
      if (BK) {
        ld16(sB + j * L::kLdr + kq, b[jj]);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) b[jj][u] = sB[(kq + u) * L::kLdr + j];
      }
    }
#pragma unroll
    for (int r = 0; r < HI; ++r) {
      const int row = ty + 32 * r;
      if (AK) {
        ld16(sA + row * L::kLdr + kq, a[r]);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) a[r][u] = sA[(kq + u) * L::kLdk + row];
      }
    }
    // k outermost: 4 HI independent FMAs between two on the same accumulator
#pragma unroll
    for (int u = 0; u < V; ++u)
#pragma unroll
      for (int r = 0; r < HI; ++r)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[r][jj] += a[r][u] * b[jj][u];
  }
}

template <typename T, bool AK, bool BK>
__device__ __forceinline__ void slab_fma_n(T (&acc)[8][4], const T* sA, const T* sB, int hi, int ty,
                                           int tx) {
  switch (hi) {
    case 1: slab_fma<T, AK, BK, 1>(acc, sA, sB, ty, tx); break;
    case 2: slab_fma<T, AK, BK, 2>(acc, sA, sB, ty, tx); break;
    case 3: slab_fma<T, AK, BK, 3>(acc, sA, sB, ty, tx); break;
    case 4: slab_fma<T, AK, BK, 4>(acc, sA, sB, ty, tx); break;
    case 5: slab_fma<T, AK, BK, 5>(acc, sA, sB, ty, tx); break;
    case 6: slab_fma<T, AK, BK, 6>(acc, sA, sB, ty, tx); break;
    case 7: slab_fma<T, AK, BK, 7>(acc, sA, sB, ty, tx); break;
    default: break;  // a slab has at most 7 row groups (224 rows)
  }
}

// The product acc[r][jj] = sum over k in [0, kB nslab) of A(row, k) B(k, j)
// for row = ty + 32 r (r < hi <= 7) and j = tx + 8 jj, every warp busy.
// A(row, k) is the logical entry AK ? (ar0 + row, k) : (k, ar0 + row) of ma,
// B(k, j) is BK ? (br0 + j, k) : (k, br0 + j) of mb.  With TRI slab s reaches
// only the rows below 32 (s + 1): the rows of an inverse's structural zeros
// are neither loaded nor multiplied.  Slab s goes through stage
// (st0 + s) % nst of sS by cp.async, 16 bytes a copy where n and both
// matrices allow it.  With three stages two slabs are in flight while one is
// multiplied (two stages timed the same on the H100: the product, not the
// copy's latency, sets a slab's time).
template <typename T, bool AK, bool BK, bool TRI, bool FLIP>
struct Gemm {
  T* sS;
  const T* ma;
  int ar0;
  const T* mb;
  int br0;
  Geo<FLIP> g;
  int nslab, hi, st0, nst;

  __device__ int rows_of(int s) const { return TRI ? min(hi, s + 1) : hi; }
  __device__ T* stage(int s) const { return sS + (st0 + s) % nst * Lay<T>::kStage; }

  // Slab s into its stage, one cp.async group.  The stage must be free: no
  // thread still reads it.
  __device__ void issue(int s) const {
    using L = Lay<T>;
    const bool vec = !FLIP && g.n % L::kVec == 0 && reinterpret_cast<size_t>(ma) % 16 == 0 &&
                     reinterpret_cast<size_t>(mb) % 16 == 0;
    T* sA = stage(s);
    load_slab<T, AK, FLIP>(sA, L::kLdk, ma, g, ar0, s * kB, kB * rows_of(s), vec);
    load_slab<T, BK, FLIP>(sA + L::kAElems, L::kLdr, mb, g, br0, s * kB, kB, vec);
    cp_async_commit();
  }

  // The whole product; slab 0 may have been issued already (a prefetch in
  // the previous step's serial phases).  One block barrier a slab: the one
  // that makes slab s visible also frees the stage of slab s - 1, which then
  // takes slab s + nst - 1.  Returns without a final barrier: the caller
  // synchronises before it writes a stage or the panel.
  __device__ void run(T (&acc)[8][4], bool issued0) const {
    using L = Lay<T>;
    const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[r][jj] = T(0);
    if (hi <= 0 || nslab <= 0) return;
    if (!issued0) issue(0);
    if (nst == 3 && nslab > 1) issue(1);
    for (int s = 0; s < nslab; ++s) {
      if (nst == 3 && s + 1 < nslab) {
        cp_async_wait<1>();  // slab s landed; s + 1 may be in flight
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (s + nst - 1 < nslab) issue(s + nst - 1);
      const T* sA = stage(s);
      slab_fma_n<T, AK, BK>(acc, sA, sA + L::kAElems, rows_of(s), ty, tx);
    }
  }
};

// ---------------------------------------------------------------------------
// per-warp and per-thread pieces of a panel step
// ---------------------------------------------------------------------------

// v[c] -= f * buf[c] for c in [c1, 32): buf read 16 bytes at a time, all of
// it before the first FMA, so one load latency is paid, not one per entry.
template <typename T>
__device__ __forceinline__ void update_tail(T (&v)[kB], T f, const T* buf, int c1) {
  constexpr int V = Lay<T>::kVec;
  T q[kB];
#pragma unroll
  for (int c0 = c1 / V * V; c0 < kB; c0 += V) {
    T t[V];
    ld16(buf + c0, t);
#pragma unroll
    for (int u = 0; u < V; ++u) q[c0 + u] = t[u];
  }
#pragma unroll
  for (int c = c1; c < kB; ++c) v[c] -= f * q[c];
}

// Cholesky of the 32 x 32 block p (row stride kLdP) by one warp, lane r
// holding row r in registers: the twin's column loop, d = sqrt(w_kk), the
// column below scaled by 1/d, the trailing lower triangle updated.  The
// pivots are a dependent chain; each step updates the next column first and
// starts the next pivot (its sqrt and reciprocal square root side by side)
// before the rest of its update, which hides their latency.  Column k goes
// to the other lanes through cb (two 32-entry buffers, alternating, so one
// __syncwarp a step suffices): one store and broadcast loads, where
// shuffles would cost one (two in f64) per entry.  The update runs on every
// lane: above the diagonal it writes entries nothing reads.  The upper
// triangle is written as zeros, and rcp[c] = 1 / L(c, c) for the rows below.
template <typename T>
__device__ __forceinline__ void warp_potrf(T* p, T* cb, T* rcp, int lane) {
  T v[kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) v[c] = p[lane * kLdP + c];
  T w = __shfl_sync(0xffffffffu, v[0], 0);
  T d = dev_sqrt(w), r = dev_rsqrt(w);
  T mine = T(0);
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    if (lane == k) mine = r;
    v[k] = lane > k ? v[k] * r : (lane == k ? d : v[k]);
    if (k + 1 < kB) {
      T* col = cb + (k & 1) * kB;
      col[lane] = v[k];  // L(lane, k) at and below the diagonal
      __syncwarp();
      v[k + 1] -= v[k] * col[k + 1];
      w = __shfl_sync(0xffffffffu, v[k + 1], k + 1);
      d = dev_sqrt(w);
      r = dev_rsqrt(w);
      update_tail<T>(v, v[k], col, k + 2);
    }
  }
#pragma unroll
  for (int c = 0; c < kB; ++c) p[lane * kLdP + c] = (c <= lane) ? v[c] : T(0);
  rcp[lane] = mine;
}

// No-pivot LU of the 32 x 32 block p by one warp, packed L\U in place: the
// twin's column loop, the column below the pivot scaled by 1 / denom (denom
// is 1 where the pivot is 0), the trailing block updated, pipelined as
// warp_potrf.  Row k of U, which every lane needs, is one lane's registers:
// that lane stores it to rb (two buffers, alternating) 16 bytes at a time and
// the others read it back the same way.  Rows at or above the pivot subtract
// 0 * U(k, c), as the twin does.  rcp[c] = 1 / denom(U(c, c)) for the rows
// below.
template <typename T>
__device__ __forceinline__ void warp_getrf(T* p, T* rb, T* rcp, int lane) {
  constexpr int V = Lay<T>::kVec;
  T v[kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) v[c] = p[lane * kLdP + c];
  T piv = __shfl_sync(0xffffffffu, v[0], 0);
  T r = dev_rcp(piv == T(0) ? T(1) : piv);
  T mine = T(0);
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    if (lane == k) mine = r;
    const T lk = lane > k ? v[k] * r : T(0);  // L(lane, k) below the pivot
    if (lane > k) v[k] = lk;
    if (k + 1 < kB) {
      T* row = rb + (k & 1) * kB;
      if (lane == k) {
#pragma unroll
        for (int c0 = (k + 1) / V * V; c0 < kB; c0 += V) {
          T t[V];
#pragma unroll
          for (int u = 0; u < V; ++u) t[u] = v[c0 + u];
          st16(row + c0, t);
        }
      }
      __syncwarp();
      v[k + 1] -= lk * row[k + 1];
      piv = __shfl_sync(0xffffffffu, v[k + 1], k + 1);
      r = dev_rcp(piv == T(0) ? T(1) : piv);
      update_tail<T>(v, lk, row, k + 2);
    }
  }
#pragma unroll
  for (int c = 0; c < kB; ++c) p[lane * kLdP + c] = v[c];
  rcp[lane] = mine;
}

// One row of the panel below the diagonal block, in place: CHOL solves
// u L^T = w with L the lower triangle of d, otherwise u U = w with U the
// upper triangle of d; rcp holds the reciprocals of the divisors (the warp
// routines above wrote them).  The twin's column loop for that row, in the
// same order.
template <typename T, bool CHOL>
__device__ __forceinline__ void row_solve(T* row, const T* d, const T* rcp) {
  T u[kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) u[c] = row[c];
#pragma unroll
  for (int c = 0; c < kB; ++c) {
    u[c] *= rcp[c];
#pragma unroll
    for (int c2 = c + 1; c2 < kB; ++c2) u[c2] -= u[c] * (CHOL ? d[c2 * kLdP + c] : d[c * kLdP + c2]);
  }
#pragma unroll
  for (int c = 0; c < kB; ++c) row[c] = u[c];
}

// ---------------------------------------------------------------------------
// the triangular inverse, by block rows
// ---------------------------------------------------------------------------

// X = L^-1 for the logical lower triangle L of m (UNIT: unit diagonal, the
// strict lower triangle read), written to x with its upper triangle zero.
// FLIP works on the exchange mirror: L = J U J for the upper triangle U of m
// and X = J U^-1 J, so x receives U^-1 with its lower triangle zero.
//
// Block row I: C = E_I - L[I, :I] X[:I, :] by the slab product (C held
// transposed in the panel, one row per column of X), then X[I, :] =
// L_II^-1 C by substitution, one column per thread, in the twin's per-row
// order (subtract, then scale by the reciprocal of the raw diagonal).
//
// The twins form each row of X with a product over the FULL row, so the
// structural zeros of X take part.  Where a diagonal L(p, p) is zero or NaN,
// the twin's row p is non-finite in every column, its entries right of the
// diagonal (which a triangular order never forms) included, and their product
// with L(t, p) makes every later row t non-finite from column p + 1 on.  So
// with p the first such row, the entries t >= c > p are NaN here (where the
// triangular order would leave some finite), and the rest is the natural
// value; for a finite block that is exactly the twin's NaN/finite mask.  In
// a non-SPD Cholesky every row from the bad one on has a NaN diagonal, so the
// rule changes nothing there; for U^-1 it is the zero-pivot pattern (every
// row above the last zero pivot non-finite).  UNIT has no division and, for a
// finite L, no non-finite entry.
//
// Padding: logical entries off the n x n matrix load as 0 and the padded
// diagonal of L_II as 1.  A stored entry (t, c) only reads X(k, c) with
// c <= k <= t, so a padded row k (FLIP puts them first) meets a stored column
// only in X's upper triangle, which is zero either way.
template <typename T, bool UNIT, bool FLIP>
__device__ void tri_inverse(const T* m, T* x, int n, Smem<T> sm, int* s_first) {
  const int tid = threadIdx.x;
  const int npad = (n + kB - 1) / kB * kB;
  const Geo<FLIP> g{n, npad};
  int first = INT_MAX;
  if (!UNIT) {
    if (tid == 0) *s_first = INT_MAX;
    __syncthreads();
    for (int t = tid; t < npad; t += kThreads) {
      const T* e = g.at(m, t, t);
      if (e && !(*e != T(0))) atomicMin(s_first, t);
    }
    __syncthreads();
    first = *s_first;
  }
  const int ty = tid >> 3, tx = tid & 7;
  T* sD = sm.diag;
  for (int I = 0; I < npad / kB; ++I) {
    const int ib = I * kB;
    // the diagonal block (lower part only) in flight during the product
    for (int idx = tid; idx < kB * kB; idx += kThreads) {
      const int t = idx / kB, k = idx % kB;
      const T* e = (UNIT ? k < t : k <= t) ? g.at(m, ib + t, ib + k) : nullptr;
      cp_async(sD + t * kLdP + k, e ? e : m, e != nullptr);
    }
    cp_async_commit();
    T acc[8][4];
    Gemm<T, false, true, true, FLIP>{sm.slab, x, 0, m, ib, g, I, 8, 0, 3}.run(acc, I > 1);
    cp_async_wait<0>();
    __syncthreads();  // the product's stages are read; C goes to the third
    // C^T[c][j] = delta(c, ib + j) - acc, for the columns c < ib + 32
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r <= I) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = ty + 32 * r, j = tx + 8 * jj;
          sm.panel[c * kLdP + j] = (c == ib + j ? T(1) : T(0)) - acc[r][jj];
        }
      }
    }
    __syncthreads();
    // the next block row's first slab (rows 0..31 of X are final) in flight
    // during this one's substitution and stores
    if (I >= 1 && ib + kB < npad) {
      Gemm<T, false, true, true, FLIP>{sm.slab, x, 0, m, ib + kB, g, I + 1, 8, 0, 3}.issue(0);
    }
    if (!UNIT && tid < kB) {  // the padded diagonal is 1; the divisors' reciprocals
      T* dt = sD + tid * kLdP + tid;
      if (!g.at(m, ib + tid, ib + tid)) *dt = T(1);
      sm.rcp[tid] = dev_rcp(*dt);
    }
    __syncthreads();
    if (tid < (I + 1) * kB) {
      T xv[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) xv[j] = sm.panel[tid * kLdP + j];
#pragma unroll
      for (int t = 0; t < kB; ++t) {
        if (!UNIT) xv[t] *= sm.rcp[t];
#pragma unroll
        for (int t2 = t + 1; t2 < kB; ++t2) xv[t2] -= sD[t2 * kLdP + t] * xv[t];
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) sm.panel[tid * kLdP + j] = xv[j];
    }
    __syncthreads();
    // logical rows ib .. ib + 31 in full: X on and below the diagonal (the
    // NaN rule applied), zero above; 16 bytes a store where n allows
    auto value = [&](int t, int c) {
      if (c > t) return T(0);
      if (!UNIT && c > first) return quiet_nan<T>();
      return sm.panel[c * kLdP + (t - ib)];
    };
    const int lane = tid & 31, warp = tid >> 5;
    if (n % Lay<T>::kVec == 0 && reinterpret_cast<size_t>(x) % 16 == 0) {
      constexpr int V = Lay<T>::kVec;
      for (int j = warp; j < kB; j += kThreads / 32) {
        const int t = ib + j, pt = g.phys(t);
        if (pt >= n) continue;
        for (int pc0 = lane * V; pc0 < n; pc0 += 32 * V) {
          T v[V];
#pragma unroll
          for (int u = 0; u < V; ++u) v[u] = value(t, g.phys(pc0 + u));
          st16(x + pt * n + pc0, v);
        }
      }
    } else {
      for (int j = warp; j < kB; j += kThreads / 32) {
        const int t = ib + j, pt = g.phys(t);
        if (pt >= n) continue;
        for (int pc = lane; pc < n; pc += 32) x[pt * n + pc] = value(t, g.phys(pc));
      }
    }
    __syncthreads();
  }
}

}  // namespace diag_block
