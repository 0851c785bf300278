// qr_panel.cu -- the Householder panel QR with its compact-WY T, on Hopper (sm_90a).
//
// Replaces two TPU kernels of slate_tpu/ops/pallas_ops.py:
//   :632 qr_panel_pallas         (m, w) -> packed VR, tau, T    (_panel_qr + _larft)
//   :659 qr_panel_offset_pallas  (m, w), row0 -> r, v, tau, T   (_panel_qr_offset + _larft_v)
// Wrappers: slate_tpu_torch/ops/kernels.py (qr_panel, qr_panel_offset);
// consumers: linalg/qr.py (the leaves of geqrf_array, the panels of
// geqrf_scan_array) and parallel/dist_qr.py (the local CAQR panel of every
// geqrf_dist step, batched over the owning mesh column's p devices, and the
// (2nb, nb) tree merges).
//
// What it computes, per panel b of a batch (one launch for the batch):
// Householder reflections H_j = I - tau_j v_j v_j^T for j < steps, the pivot of
// column j at row g_j = row0 + j (row0 = 0 for qr_panel, which runs
// steps = min(m, w); the offset form runs w steps and needs row0 + w <= m).
// Per column, as slate_tpu's _panel_qr / _panel_qr_offset bodies:
//   alpha = A[g, j], xnorm2 = sum_{i > g} A[i, j]^2, anorm = sqrt(alpha^2 + xnorm2),
//   s = (alpha >= 0) ? 1 : -1 (so -0.0 -> +1 and NaN -> -1, not copysign),
//   dead = (anorm == 0), beta = dead ? 1 : -s anorm, tau = dead ? 0 : (beta - alpha) / beta,
//   denom = alpha - beta (1 where that is 0), v_i = A[i, j] / denom below g,
//   v_g = 1 (the offset form: 0 for a dead column), R[g, j] = dead ? alpha : beta,
//   A[:, k] -= (tau v) (v^T A[:, k]) for k > j.
// T is the forward-columnwise larft: T[j, j] = tau_j,
// T[:j, j] = -tau_j T[:j, :j] (V[:, :j]^T v_j).
//
// What bounds it: a panel moves 2 m w elements at least (A in, the factor
// out; the offset form also writes V) and does ~3 m w^2 flops (the
// reflections and the Gram of T): ~0.1 ms for the f32 mesh panel, a few
// microseconds for a leaf.  The real floor is latency: w dependent column
// steps, each a reduction over every row of the panel, that is, an exchange
// among the CTAs that hold the rows.  chip_smoke.py reads it as w column
// exchanges plus two block barriers a block, each timed empty at the launch's
// grid (qr_probe_f32 / _f64 below): ~0.5 ms of the f32 mesh panel's 1.26 ms
// on the H100.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel: every CTA
// resident, one per SM) of kThreads-thread CTAs; CTA c of a panel owns rows
// [c rpc, (c + 1) rpc), rpc = ceil(m / nc), nc = min(SMs / batch,
// ceil(m / kMinRows), kMaxNc) (kMaxNc 128 in f32, 64 in f64).  The shape and
// the card alone fix the grid, so a call always takes the same sums.  The
// factor is built in the output buffers (row-major, in global memory; the
// first block reads A itself).  The column loop is blocked by kIb = 32:
//   block load: each CTA's rows of the block's columns into shared memory
//     (S, rpc x kIb; in global memory when that does not fit, a second
//     instantiation picked by shape alone);
//   column step (one exchange, no barrier): every CTA publishes its partials
//     x^T S[:, k] over its rows below the pivot (x = column j: k = j gives
//     ||x||^2, k > j the dots with the block's later columns, k < j those
//     with its earlier reflectors), each value tagged with its step in one
//     64-bit word (f32; f64 two words), and the pivot row's owner publishes
//     that row; every CTA sums the CTAs' partials in one fixed order as they
//     arrive, so each derives the same beta, tau, denom and
//     v^T a_k = (x^T a_k) / denom + u a_{g,k} (the norm fused with the dots:
//     rounding moves, the algorithm does not).  Then warp w takes the rows
//     r = w (mod 16), lane = column: the pivot row and the next, then each
//     row below them a load, two shuffles, two FMAs and a store (the update
//     a_k += x c_k of the block's later columns, v = x / denom into column j)
//     and at once the look-ahead: the partials of column j + 1 from the
//     updated row.  T_b's column j (T_b[:j, j] = -tau T_b[:j, :j] g, g the
//     Gram column the step summed) is formed by one warp while the next
//     exchange is in flight;
//   block end (two barriers, release / acquire counters): the block goes out
//     to the panel (R, packed V; the offset form splits r and v) and S
//     becomes V_b; each CTA forms V_b^T over its rows of every other column of
//     the panel (the finished reflectors left of the block: the Gram
//     V_{<b}^T V_b; the trailing columns: W = V_b^T A_t), the rows staged
//     through shared memory kStages tiles deep by cp.async, 16 FMAs a row a
//     thread, into per-CTA partials; barrier; CTA c sums its share of the
//     columns over the CTAs in order and applies T_b^T (Y = T_b^T P);
//     barrier; every CTA updates its rows of the trailing columns
//     A_t -= V_b Y_t (staged the same way, Y's column in registers), and the
//     rows of the off-diagonal block
//     T[:j0, b] = -T[:j0, :j0] (V_{<b}^T V_b) T_b = -T[:j0, :j0] Y[:, <j0]^T
//     are spread over the CTAs (row i by CTA i mod nc); CTA 0 writes T_b and
//     tau.
// So w exchanges and 2 w / kIb barriers (16 at w = 256; the first kernel had
// 2 w grid barriers), and w / kIb passes over the panel's trailing columns
// in place of w.  No atomics, and no sum whose order depends on scheduling.
// The order is not slate_tpu's (a matmul there), so the result agrees with
// the twins to O(m eps), not bitwise.
//
// What it leaves on the table: the exchange is the floor (1.9 us a column
// at 66 CTAs in f32, 2.8 us at 64 in f64: every CTA reads every CTA's
// partials, L2 traffic as nc^2); the block products read V_{<b} again for
// the Gram and run on FFMA / DFMA from shared memory (no tensor cores: no
// TF32 in this path), and at the mesh panel's size they stream ~0.5 GB
// through L2 and HBM a launch; f64 spills ~0.4 KB a thread (128 registers,
// one CTA an SM); a thread-block cluster could replace the L2 exchange by
// distributed shared memory for panels that fit in 16 SMs.
//
// C interface (ctypes), row-major contiguous (batch, m, w) panels on the
// current device, launched on `stream`; no synchronisation, no allocation:
//   qr_panel_plan_f32 / _f64(batch, m, w, &scratch_elems) -> CTAs per panel
//     (or -1): the grid and the scratch the launch needs, in elements of the
//     dtype;
//   qr_panel_f32 / _f64(a, work, v, tau, t, row0, scratch, batch, m, w, nc,
//     offset, stream) -> cudaError_t of the launch.  work: the packed VR
//     (offset = 0) or r (offset = 1); v: the reflectors (offset = 1, else
//     unused); tau (batch, w); t (batch, w, w); row0: batch ints in HOST
//     memory (offset = 1), passed to the kernel by value;
//   qr_probe_f32 / _f64(batch, nc, iters, mode, scratch, stream): `iters`
//     empty column exchanges (mode 0) or block barriers (mode 1) at the grid
//     (batch, nc), scratch of qr_probe_scratch_bytes(sizeof(T), batch, nc);
//   qr_panel_smem_bytes(sizeof(T), batch, m, w): the launch's dynamic shared
//     memory.
// Tuning builds (tools/qr_panel_report.py): -DQR_PROFILE adds per-phase
// clock sums per CTA (qr_prof_read).

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kIb = 32;       // the inner block: one column per lane
constexpr int kLd = kIb + 1;  // padded row of the small shared buffers
constexpr int kMaxW = 256;
constexpr int kMinRows = 32;  // rows per CTA at least (fewer CTAs for short panels)
// CTAs per panel at most: f32 one round of the exchange's loads; f64 half
// that, since each value is two tagged words and the exchange's L2 traffic
// grows as nc^2
constexpr int kMaxNcF32 = 8 * kWarps;
constexpr int kMaxNcF64 = 4 * kWarps;
constexpr int kMaxBatch = 256;         // row0 by value
constexpr int kStages = 4;             // staged row tiles in flight
constexpr int kMaxChunkRows = 32;      // rows a staged tile holds at most
// the staging area: kStages row tiles of the panel (rc x w each), or Y's
// columns (w x kLd)
constexpr int kStageBytes = 96 * 1024;
static_assert(kStageBytes / 8 >= kMaxW * kLd, "Y's columns fit the staging area");

template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return kStageBytes / static_cast<int>(sizeof(T));
}

// rows a staged tile holds at width w
template <typename T>
__host__ __device__ int chunk_rows(int w) {
  const int r = stage_elems<T>() / (kStages * w);
  return r < kMaxChunkRows ? r : kMaxChunkRows;
}

template <typename T>
struct Args {
  const T* a;
  T* work;
  T* v;
  T* tau;
  T* t;
  unsigned* flags;  // (batch, nc): the block barriers' counters
  u64* pst;  // (batch, 2, nc, kIb, words): a column step's per-CTA partials, tagged, two parities
  u64* piv;  // (batch, 2, kIb, words): the step's pivot row, tagged
  T* pb;     // (batch, nc, w, kIb): the block products' per-CTA partials
  T* yg;     // (batch, w, kIb): Y = T_b^T P
  T* sglob;  // (batch, nc, rpc, kIb): the blocks when they are kept in global memory
  int m, w, nc, rpc, offset;
  int vec16;  // the panel rows and buffers allow 16-byte copies
  int row0[kMaxBatch];
};

// ---------------------------------------------------------------------------
// the column exchange: values tagged with their step, 32 bits of value and 32
// of tag in one 64-bit word (single-copy atomic), so a reader that sees its
// tag has the value: no fence, no flag, no second round trip
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ll_store(u64* p, unsigned tag, unsigned bits) {
  const u64 v = (static_cast<u64>(tag) << 32) | bits;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 ll_load(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ll_settle(u64 v, const u64* p, unsigned tag) {
  while (static_cast<unsigned>(v >> 32) != tag) v = ll_load(p);
  return static_cast<unsigned>(v);
}

template <typename T>
struct LL;

template <>
struct LL<float> {
  static constexpr int kWords = 1;
  __device__ static void put(u64* p, unsigned tag, float x) { ll_store(p, tag, __float_as_uint(x)); }
  __device__ static void load(const u64* p, u64* v) { v[0] = ll_load(p); }
  __device__ static float settle(const u64* v, const u64* p, unsigned tag) {
    return __uint_as_float(ll_settle(v[0], p, tag));
  }
};

template <>
struct LL<double> {
  static constexpr int kWords = 2;
  __device__ static void put(u64* p, unsigned tag, double x) {
    const u64 b = static_cast<u64>(__double_as_longlong(x));
    ll_store(p, tag, static_cast<unsigned>(b));
    ll_store(p + 1, tag, static_cast<unsigned>(b >> 32));
  }
  __device__ static void load(const u64* p, u64* v) {
    v[0] = ll_load(p);
    v[1] = ll_load(p + 1);
  }
  __device__ static double settle(const u64* v, const u64* p, unsigned tag) {
    const u64 lo = ll_settle(v[0], p, tag), hi = ll_settle(v[1], p + 1, tag);
    return __longlong_as_double(static_cast<long long>((hi << 32) | lo));
  }
};

// sum over cc = first, first + kWarps, ... < nc (in that order) of entry
// `lane` of CTA cc's tagged row; 8 loads in flight a thread
template <typename T>
__device__ T ll_sum_rows(const u64* rows, int first, int nc, int lane, unsigned tag) {
  constexpr int W = LL<T>::kWords;
  T x = T(0);
  for (int c0 = first; c0 < nc; c0 += 8 * kWarps) {
    u64 v[8][W];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int cc = c0 + u * kWarps;
      if (cc < nc) LL<T>::load(rows + (static_cast<size_t>(cc) * kIb + lane) * W, v[u]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int cc = c0 + u * kWarps;
      if (cc < nc) x += LL<T>::settle(v[u], rows + (static_cast<size_t>(cc) * kIb + lane) * W, tag);
    }
  }
  return x;
}

// ---------------------------------------------------------------------------
// the block barrier: CTA c publishes how many barriers it has reached; each
// waits until every counter of its panel has reached it (release / acquire
// as CUTLASS's GenericBarrier; no atomics, no coupling of a batch's panels)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void flag_store(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned flag_load(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

struct PanelBarrier {
  unsigned* flags;
  int nc, c;
  unsigned s;

  __device__ void sync() {
    __syncthreads();
    ++s;
    if (threadIdx.x == 0) flag_store(flags + c, s);
    if (threadIdx.x < nc) {
      while (flag_load(flags + threadIdx.x) < s) {
      }
    }
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// asynchronous copies of panel rows into shared memory
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void cp_async(T* s, const T* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(sa), "l"(g), "n"(sizeof(T)) : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async16(T* s, const T* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(g) : "memory");
}

// columns [c_lo, c_hi) of one panel row into a tile row, by one warp: in
// 16-byte copies where the range and the rows allow them
template <typename T>
__device__ __forceinline__ void stage_range(T* trow, const T* grow, int c_lo, int c_hi, int lane, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (vec && c_lo % V == 0 && c_hi % V == 0) {
    for (int col = c_lo + lane * V; col < c_hi; col += 32 * V) cp_async16(trow + col, grow + col);
  } else {
    for (int col = c_lo + lane; col < c_hi; col += 32) cp_async(trow + col, grow + col);
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A CTA's rows [rbeg, R) of the panel's columns outside the block, staged
// kStages tiles of rc rows deep: the finished reflectors left of the block
// (from V, when `left`) and the trailing columns (from Src).  body(tile,
// first local row, rows) runs once a tile, in row order, every thread.
template <typename T, typename Body>
__device__ void stream_rows(T* area, const T* Src, const T* V, int lo, int rbeg, int R, int w, int j0, int jend,
                            bool left, bool vec, int rc, Body body) {
  const int nch = (R - rbeg + rc - 1) / rc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto issue = [&](int ch) {
    if (ch < nch) {
      T* tile = area + (ch % kStages) * rc * w;
      const int ra = rbeg + ch * rc, nr = min(rc, R - ra);
      for (int r = warp; r < nr; r += kWarps) {
        const size_t g = static_cast<size_t>(lo + ra + r) * w;
        if (left) stage_range(tile + r * w, V + g, 0, j0, lane, vec);
        stage_range(tile + r * w, Src + g, jend, w, lane, vec);
      }
    }
    cp_commit();  // an empty group past the end keeps the count
  };
  for (int ch = 0; ch < kStages - 1; ++ch) issue(ch);
  for (int ch = 0; ch < nch; ++ch) {
    issue(ch + kStages - 1);
    cp_wait<kStages - 1>();
    __syncthreads();
    const int ra = rbeg + ch * rc;
    body(area + (ch % kStages) * rc * w, ra, min(rc, R - ra));
    __syncthreads();  // the tile is refilled kStages chunks on
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// shared memory
// ---------------------------------------------------------------------------

template <typename T>
struct Shared {
  T* u;     // stage_elems<T>(): the staged row tiles, or Y's columns
  T* red;   // 2 x kWarps x kIb: the step sums, the look-ahead partials
  T* gram;  // kIb x kLd: the block's Gram, gram[k][j] = v_k^T v_j (k < j)
  T* tbb;   // kIb x kLd: the block's T_b
  T* zs;    // kIb
  T* taus;  // kIb
  T* us;    // kIb: the reflectors' pivot entries (1, or 0 for a dead offset column)
  T* sc;    // 4: tau, 1 / denom, u, R's diagonal entry
};

template <typename T>
__host__ __device__ constexpr size_t fixed_elems() {
  return static_cast<size_t>(stage_elems<T>()) + 2 * kWarps * kIb + 2 * kIb * kLd + 3 * kIb + 4;
}

template <typename T>
__host__ __device__ size_t smem_bytes(int rpc, bool in_smem) {
  return ((in_smem ? static_cast<size_t>(rpc) * kIb : 0) + fixed_elems<T>()) * sizeof(T);
}

// n consecutive elements of a 16-byte aligned row, as 16-byte loads
__device__ __forceinline__ void load_row(const float* p, float* out, int n) {
  for (int q = 0; q < n; q += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + q);
    out[q] = x.x;
    out[q + 1] = x.y;
    out[q + 2] = x.z;
    out[q + 3] = x.w;
  }
}

__device__ __forceinline__ void load_row(const double* p, double* out, int n) {
  for (int q = 0; q < n; q += 2) {
    const double2 x = *reinterpret_cast<const double2*>(p + q);
    out[q] = x.x;
    out[q + 1] = x.y;
  }
}

// the first local row r >= r_lo with r = warp (mod kWarps)
__device__ __forceinline__ int first_row(int r_lo, int warp) {
  const int r = r_lo > 0 ? r_lo : 0;
  return r + ((warp - r) % kWarps + kWarps) % kWarps;
}

// The end of a column pass: the per-warp partials (lane k: column k)
// summed over the warps in order and published by warp 0 with the step's tag
template <typename T>
__device__ void publish(T acc, T* red, u64* row, unsigned tag) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  red[warp * kIb + lane] = acc;
  __syncthreads();
  if (warp == 0) {
    T x = T(0);
    for (int gg = 0; gg < kWarps; ++gg) x += red[gg * kIb + lane];
    LL<T>::put(row + lane * LL<T>::kWords, tag, x);
  }
}

// column jj of the block's T_b (one warp; lane i < jj: row i):
// T_b[i, jj] = -tau_jj sum_{i <= l < jj} T_b[i, l] gram[l, jj], T_b[jj, jj] = tau_jj
template <typename T>
__device__ void tb_column(T* tbb, const T* gram, const T* taus, int jj, int lane) {
  if (lane < jj) {
    T x = T(0);
    for (int l = lane; l < jj; ++l) x += tbb[lane * kLd + l] * gram[l * kLd + jj];
    tbb[lane * kLd + jj] = -taus[jj] * x;
  } else if (lane == jj) {
    tbb[jj * kLd + jj] = taus[jj];
  }
}

// The column steps of one block, shared by both row layouts: the exchange
// of a step's partials and its reflector, in every CTA alike.
template <typename T>
struct Steps {
  u64* pst;
  u64* piv;
  int nc, c, lo, R, r0, offset;
  Shared<T> sh;
  T* redp;  // the look-ahead partials

  // step q (column jj of the block): the sums over the CTAs (warp gg adds
  // the CTAs cc = gg (mod kWarps), in order; warp 0 the warps, in order)
  // and the pivot row; warp 0 forms the reflector into sh
  __device__ void reflector(int jj, int q) const {
    constexpr int W = LL<T>::kWords;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, par = q & 1;
    const unsigned tag = q + 1;
    u64 vp[W];
    const u64* pp = piv + (par * kIb + lane) * W;
    if (warp == 0) LL<T>::load(pp, vp);
    sh.red[warp * kIb + lane] = ll_sum_rows<T>(pst + static_cast<size_t>(par) * nc * kIb * W, warp, nc, lane, tag);
    __syncthreads();
    if (warp == 0) {
      T d = T(0);
      for (int gg = 0; gg < kWarps; ++gg) d += sh.red[gg * kIb + lane];
      const T pv = LL<T>::settle(vp, pp, tag);
      const T alpha = __shfl_sync(0xffffffffu, pv, jj);
      const T xn2 = __shfl_sync(0xffffffffu, d, jj);
      const T anorm = sqrt(alpha * alpha + xn2);
      const T s = (alpha >= T(0)) ? T(1) : T(-1);
      const bool dead = anorm == T(0);
      const T beta = dead ? T(1) : -s * anorm;
      const T tj = dead ? T(0) : (beta - alpha) / beta;
      T denom = alpha - beta;
      if (denom == T(0)) denom = T(1);
      const T rden = T(1) / denom;
      const T u = (offset && dead) ? T(0) : T(1);
      // k > jj: v^T a_k; k < jj: v_k^T v_j, the Gram column of T_b
      const T z = d * rden + u * pv;
      sh.zs[lane] = z;
      if (lane < jj) sh.gram[lane * kLd + jj] = z;
      if (lane == 0) {
        sh.sc[0] = tj;
        sh.sc[1] = rden;
        sh.sc[2] = u;
        sh.sc[3] = dead ? alpha : beta;
        sh.taus[jj] = tj;
        sh.us[jj] = u;
      }
    }
    __syncthreads();
  }

  // this CTA's partials of step q (lane k of each warp: column k)
  __device__ void partials(T acc, int q) const {
    publish(acc, redp, pst + ((static_cast<size_t>(q & 1) * nc + c) * kIb) * LL<T>::kWords, q + 1);
  }

  // the pivot row of step q, value k
  __device__ void pivot(int k, T x, int q) const {
    LL<T>::put(piv + ((q & 1) * kIb + k) * LL<T>::kWords, q + 1, x);
  }

  // after column jj's update: the next column's partials, or the block's end
  __device__ void next(T acc, int jj, int ibe, int q) const {
    if (jj + 1 < ibe) {
      partials(acc, q + 1);
      // T_b's column jj, while the exchange is in flight
      if ((threadIdx.x >> 5) == 1) tb_column(sh.tbb, sh.gram, sh.taus, jj, threadIdx.x & 31);
    } else {
      __syncthreads();
      if ((threadIdx.x >> 5) == 1) tb_column(sh.tbb, sh.gram, sh.taus, jj, threadIdx.x & 31);
    }
  }
};

// The column steps of one block: lane = column, warp w taking the rows
// r = w (mod kWarps) of S.  A row below the next pivot costs a load, two
// shuffles, two FMAs and a store: a_k <- a_k + x c_k with c_k = -tau w_k /
// denom right of the column, 1 / denom on it (v = x / denom, within an ulp
// of the twins' division) and nothing left of it; then the look-ahead
// partial of the next column, acc_k += a'_{jj+1} a'_k.  The pivot row and
// the next one are taken first.
template <typename T>
__device__ void block_steps(const Steps<T>& st, T* S, int j0, int ibe, int& q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = st.lo, R = st.R;
  {  // the partials of the block's first column
    const int g = st.r0 + j0;
    T acc = T(0), pv = T(0);
    for (int r = first_row(g - lo, warp); r < R; r += kWarps) {
      const T a = S[r * kIb + lane];
      const T x = __shfl_sync(0xffffffffu, a, 0);
      if (lo + r > g) acc += x * a;
      else pv = a;
    }
    if (g >= lo && g < lo + R && (g - lo) % kWarps == warp) st.pivot(lane, pv, q);
    st.partials(acc, q);
  }
  for (int jj = 0; jj < ibe; ++jj, ++q) {
    const int g = st.r0 + j0 + jj;
    st.reflector(jj, q);
    // the update of the rows at and below the pivot, lane = column, and the
    // look-ahead: the partials of column jj + 1
    const T tj = st.sh.sc[0], rden = st.sh.sc[1], u = st.sh.sc[2], rd = st.sh.sc[3];
    const T wk = st.sh.zs[lane];
    const bool look = jj + 1 < ibe, keep = lane != jj, store = lane >= jj && lane < ibe;
    const T ck = lane > jj ? -(tj * rden) * wk : (lane == jj ? rden : T(0));
    T acc = T(0);
    // the pivot row (v_g = u, R's entry on the diagonal) and the next
    for (int i = g; i <= g + 1; ++i) {
      const int r = i - lo;
      if (r < 0 || r >= R || r % kWarps != warp) continue;
      const T a = S[r * kIb + lane];
      const T x = __shfl_sync(0xffffffffu, a, jj);
      const T vi = (i == g) ? u : x * rden;
      T an = a;
      if (lane > jj) an = a - (tj * vi) * wk;
      else if (lane == jj) an = (i == g) ? rd : vi;
      if (store) S[r * kIb + lane] = an;
      if (look && i == g + 1) st.pivot(lane, an, q + 1);
    }
    // the rows below them
    if (look) {
#pragma unroll 4
      for (int r = first_row(g + 2 - lo, warp); r < R; r += kWarps) {
        const T a = S[r * kIb + lane];
        const T x = __shfl_sync(0xffffffffu, a, jj);
        const T an = fma(x, ck, keep ? a : T(0));
        if (store) S[r * kIb + lane] = an;
        acc = fma(__shfl_sync(0xffffffffu, an, jj + 1), an, acc);
      }
    } else {
#pragma unroll 4
      for (int r = first_row(g + 2 - lo, warp); r < R; r += kWarps) {
        const T a = S[r * kIb + lane];
        const T x = __shfl_sync(0xffffffffu, a, jj);
        if (store) S[r * kIb + lane] = fma(x, ck, keep ? a : T(0));
      }
    }
    st.next(acc, jj, ibe, q);
  }
  __syncthreads();
}

// phase timings for tuning builds (-DQR_PROFILE): thread 0 of each CTA adds
// the clock cycles since its previous mark to its row of g_qr_prof
#ifdef QR_PROFILE
__device__ long long g_qr_prof[1024][16];
#define QR_MARK(slot)                   \
  do {                                  \
    const long long t_ = clock64();     \
    prof[slot] += t_ - t_mark;          \
    t_mark = t_;                        \
  } while (0)
#else
#define QR_MARK(slot) \
  do {                \
  } while (0)
#endif

template <typename T, bool kSm>
__global__ void __launch_bounds__(kThreads, 1) qr_panel_kernel(const Args<T> p) {
  constexpr int W = LL<T>::kWords;
#ifdef QR_PROFILE
  long long t_mark = clock64(), prof[14] = {};
#endif
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = p.nc, panel = blockIdx.x / nc, c = blockIdx.x % nc;
  const int m = p.m, w = p.w, rpc = p.rpc;
  const int lo = min(m, c * rpc), hi = min(m, lo + rpc), R = hi - lo;
  const int r0 = p.offset ? p.row0[panel] : 0;
  const int steps = p.offset ? w : min(m, w);
  const size_t poff = static_cast<size_t>(panel) * m * w;
  const T* A = p.a + poff;
  T* Wk = p.work + poff;                 // the packed VR, or r
  T* Vout = p.offset ? p.v + poff : Wk;  // where finished reflectors are read back
  T* tau_out = p.tau + static_cast<size_t>(panel) * w;
  T* Tm = p.t + static_cast<size_t>(panel) * w * w;
  u64* pst = p.pst + static_cast<size_t>(panel) * 2 * nc * kIb * W;
  u64* piv = p.piv + static_cast<size_t>(panel) * 2 * kIb * W;
  T* pb = p.pb + static_cast<size_t>(panel) * nc * w * kIb;
  T* yg = p.yg + static_cast<size_t>(panel) * w * kIb;

  T* base = reinterpret_cast<T*>(smem_raw);
  T* S = kSm ? base : p.sglob + (static_cast<size_t>(panel) * nc + c) * rpc * kIb;
  Shared<T> sh;
  sh.u = kSm ? base + static_cast<size_t>(rpc) * kIb : base;
  sh.red = sh.u + stage_elems<T>();
  sh.gram = sh.red + 2 * kWarps * kIb;
  sh.tbb = sh.gram + kIb * kLd;
  sh.zs = sh.tbb + kIb * kLd;
  sh.taus = sh.zs + kIb;
  sh.us = sh.taus + kIb;
  sh.sc = sh.us + kIb;
  T* redp = sh.red + kWarps * kIb;  // the look-ahead partials
  const int rc = chunk_rows<T>(w);

  PanelBarrier bar{p.flags + static_cast<size_t>(panel) * nc, nc, c, 0u};

  // 0. the rows above row0 (offset form) go to r as given: nothing touches
  // them; every other entry of r / VR is written by the steps or the block
  // updates, which read A itself in the first block.  CTA 0: the columns
  // the steps do not reach (m < w) have T = 0.
  {
    const int rtop = min(max(r0, lo), hi);
    const size_t e0 = static_cast<size_t>(lo) * w, n = static_cast<size_t>(rtop - lo) * w;
#pragma unroll 4
    for (size_t e = tid; e < n; e += kThreads) Wk[e0 + e] = A[e0 + e];
  }
  if (c == 0) {
    for (int e = tid; e < (w - steps) * w; e += kThreads)
      Tm[static_cast<size_t>(e % w) * w + steps + e / w] = T(0);
    for (int j = steps + tid; j < w; j += kThreads) tau_out[j] = T(0);
  }
  QR_MARK(0);

  int q = 0;  // column steps so far; step q's values carry the tag q + 1 and parity q & 1
  for (int j0 = 0; j0 < steps; j0 += kIb) {
    const int ibe = min(kIb, steps - j0), jend = j0 + ibe;
    const T* Src = j0 == 0 ? A : Wk;  // the columns right of the block, as the earlier blocks left them
    // the block: rows lo..hi, columns j0..jend (zeros past ibe)
#pragma unroll 8
    for (int e = tid; e < R * kIb; e += kThreads) {
      const int r = e / kIb, k = e % kIb;
      S[e] = k < ibe ? Src[static_cast<size_t>(lo + r) * w + j0 + k] : T(0);
    }
    for (int e = tid; e < kIb * kLd; e += kThreads) {
      sh.gram[e] = T(0);
      sh.tbb[e] = T(0);
    }
    __syncthreads();
    const Steps<T> st{pst, piv, nc, c, lo, R, r0, p.offset, sh, redp};
    block_steps(st, S, j0, ibe, q);
    QR_MARK(5);

    // block end: the block out to the panel; S becomes V_b
    const int gb = r0 + j0;  // the block's first pivot row: V_b is zero above it
#pragma unroll 4
    for (int e = tid; e < R * kIb; e += kThreads) {
      const int r = e / kIb, k = e % kIb;
      const int i = lo + r, gk = gb + k;
      if (k < ibe) {
        const T sv = S[e];
        const size_t g = static_cast<size_t>(i) * w + j0 + k;
        const T vv = i > gk ? sv : (i == gk ? sh.us[k] : T(0));
        if (p.offset) {
          Wk[g] = i > gk ? T(0) : sv;
          Vout[g] = vv;
        } else {
          Wk[g] = sv;
        }
        S[e] = vv;
      }
    }
    __syncthreads();
    QR_MARK(6);

    const int n_other = w - ibe;  // every column outside the block
    if (n_other > 0) {
      const int rbeg = max(gb - lo, 0);
      // P_c = V_b^T (this CTA's rows of the other columns), the rows staged:
      // thread = (column o, half kh of the block)
      {
        const int o = tid % n_other, kh = tid / n_other;
        const bool mine = tid < 2 * n_other;
        const int col = o < j0 ? o : o + ibe;
        T acc[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] = T(0);
        stream_rows(sh.u, Src, Vout, lo, rbeg, R, w, j0, jend, true, p.vec16 != 0, rc, [&](const T* tile, int ra, int nr) {
          if (!mine) return;
          for (int r = 0; r < nr; ++r) {
            const T x = tile[r * w + col];
            const T* vr = S + (ra + r) * kIb + kh * 16;
#pragma unroll
            for (int k0 = 0; k0 < 16; k0 += 4) {
              T v4[4];
              load_row(vr + k0, v4, 4);
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[k0 + k] += v4[k] * x;
            }
          }
        });
        if (mine) {
#pragma unroll
          for (int k = 0; k < 16; ++k) __stcg(pb + (static_cast<size_t>(c) * w + col) * kIb + kh * 16 + k, acc[k]);
        }
      }
      QR_MARK(7);
      bar.sync();
      QR_MARK(8);
      // Y = T_b^T P over the CTAs' partials: CTA c takes the columns o = c
      // (mod nc), na of them; gw warps a column, warp part pt adding the
      // CTAs cc = pt (mod gw) in order, then the parts in order
      {
        const int na = n_other > c ? (n_other - c + nc - 1) / nc : 0;
        const int gw = kWarps / max(1, min(na, kWarps));
        const int slots = kWarps / gw;
        for (int a0 = 0; a0 < na; a0 += slots) {
          const int slot = warp / gw, pt = warp % gw, ai = a0 + slot;
          const bool live = slot < slots && ai < na;
          const int o = c + ai * nc, col = o < j0 ? o : o + ibe;
          T x = T(0);
          if (live) {
            const T* src = pb + static_cast<size_t>(col) * kIb + lane;
            const size_t stride = static_cast<size_t>(w) * kIb;
            for (int c0 = pt; c0 < nc; c0 += 8 * gw) {
              T v8[8];
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                const int cc = c0 + u * gw;
                v8[u] = cc < nc ? __ldcg(src + cc * stride) : T(0);
              }
#pragma unroll
              for (int u = 0; u < 8; ++u) x += v8[u];
            }
          }
          sh.red[warp * kIb + lane] = x;
          __syncthreads();
          if (live && pt == 0) {
            T s = T(0);
            for (int g2 = 0; g2 < gw; ++g2) s += sh.red[(warp + g2) * kIb + lane];
            __syncwarp();
            sh.red[warp * kIb + lane] = s;
            __syncwarp();
            T y = T(0);
            for (int l = 0; l <= lane; ++l) y += sh.tbb[l * kLd + lane] * sh.red[warp * kIb + l];
            __stcg(yg + static_cast<size_t>(col) * kIb + lane, y);
          }
          __syncthreads();
        }
      }
      QR_MARK(9);
      bar.sync();
      QR_MARK(10);
      T* ys = sh.u;  // (w, kLd): Y's columns
#pragma unroll 4
      for (int e = tid; e < n_other * kIb; e += kThreads) {
        const int o = e / kIb, k = e % kIb, col = o < j0 ? o : o + ibe;
        ys[col * kLd + k] = __ldcg(yg + static_cast<size_t>(col) * kIb + k);
      }
      __syncthreads();
      // T[:j0, block] = -T[:j0, :j0] Y[:, :j0]^T: row i by CTA i mod nc, one
      // warp a row; the row's entries i..j0 loaded by the warp at once
      for (int i = c + warp * nc; i < j0; i += nc * kWarps) {
        const T* trow = Tm + static_cast<size_t>(i) * w;
        T tv[kMaxW / 32];
#pragma unroll
        for (int u = 0; u < kMaxW / 32; ++u) {
          const int l = i + 32 * u + lane;
          tv[u] = l < j0 ? __ldcg(trow + l) : T(0);
        }
        T x = T(0);
#pragma unroll
        for (int u = 0; u < kMaxW / 32; ++u) {
          if (i + 32 * u >= j0) break;
          for (int s2 = 0; s2 < 32; ++s2) {
            const int l = i + 32 * u + s2;
            if (l >= j0) break;
            x += __shfl_sync(0xffffffffu, tv[u], s2) * ys[l * kLd + lane];
          }
        }
        if (lane < ibe) Tm[static_cast<size_t>(i) * w + j0 + lane] = -x;
      }
      QR_MARK(11);
      // A_t -= V_b Y_t over this CTA's rows at or below gb, the rows staged
      // as above: thread = (column, row share), Y's column in registers
      const int n_t = w - jend;
      if (n_t > 0 && rbeg < R) {
        const int RS = max(1, kThreads / n_t);
        const int o = tid % n_t, rs = tid / n_t, col = jend + o;
        const bool mine = tid < n_t * RS;
        T y[kIb];
#pragma unroll
        for (int k = 0; k < kIb; ++k) y[k] = mine ? ys[col * kLd + k] : T(0);
        __syncthreads();  // ys is overwritten by the tiles
        stream_rows(sh.u, Src, Vout, lo, rbeg, R, w, j0, jend, false, p.vec16 != 0, rc, [&](const T* tile, int ra, int nr) {
          if (!mine) return;
          for (int r = rs; r < nr; r += RS) {
            T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll
            for (int k = 0; k < kIb; k += 8) {
              T vr[8];
              load_row(S + (ra + r) * kIb + k, vr, 8);
              s0 += vr[0] * y[k] + vr[4] * y[k + 4];
              s1 += vr[1] * y[k + 1] + vr[5] * y[k + 5];
              s2 += vr[2] * y[k + 2] + vr[6] * y[k + 6];
              s3 += vr[3] * y[k + 3] + vr[7] * y[k + 7];
            }
            Wk[static_cast<size_t>(lo + ra + r) * w + col] = tile[r * w + col] - ((s0 + s1) + (s2 + s3));
          }
        });
      }
      QR_MARK(12);
    }
    // CTA 0: the block's T_b (and zeros below it) and tau
    if (c == 0) {
      for (int e = tid; e < (w - j0) * ibe; e += kThreads) {
        const int ii = e / ibe, k = e % ibe;
        Tm[static_cast<size_t>(j0 + ii) * w + j0 + k] = (ii <= k) ? sh.tbb[ii * kLd + k] : T(0);
      }
      if (tid < ibe) tau_out[j0 + tid] = sh.taus[tid];
    }
    __syncthreads();  // S and the shared buffers are reused by the next block
    QR_MARK(13);
  }
#ifdef QR_PROFILE
  if (threadIdx.x == 0)
    for (int k = 0; k < 14; ++k) g_qr_prof[blockIdx.x % 1024][k] += prof[k];
#endif
}

// `iters` rounds of the column exchange (every CTA publishes kIb tagged
// partials and sums every CTA's, as a column step does) or, mode 1, of the
// block barrier, at the grid (batch, nc)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) qr_probe_kernel(unsigned* flags, u64* ll, int nc, int iters,
                                                               int mode, T* sink) {
  constexpr int W = LL<T>::kWords;
  const int panel = blockIdx.x / nc, c = blockIdx.x % nc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  PanelBarrier bar{flags + static_cast<size_t>(panel) * nc, nc, c, 0u};
  u64* pst = ll + static_cast<size_t>(panel) * 2 * nc * kIb * W;
  __shared__ T red[2 * kWarps * kIb];
  T acc = T(0);
  for (int it = 0; it < iters; ++it) {
    if (mode == 1) {
      bar.sync();
      continue;
    }
    const unsigned tag = it + 1;
    const int par = it & 1;
    publish(T(c), red + kWarps * kIb, pst + ((static_cast<size_t>(par) * nc + c) * kIb) * W, tag);
    red[warp * kIb + lane] = ll_sum_rows<T>(pst + static_cast<size_t>(par) * nc * kIb * W, warp, nc, lane, tag);
    __syncthreads();
    if (warp == 0)
      for (int gg = 0; gg < kWarps; ++gg) acc += red[gg * kIb + lane];
    __syncthreads();
  }
  if (acc == T(-1)) sink[0] = acc;  // keeps the sums
}

int max_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return v;
}

// the CTAs per panel: one per SM, at least kMinRows rows each, kMaxNc at most
template <typename T>
int grid_nc(int batch, int m, int sms) {
  const int by_rows = (m + kMinRows - 1) / kMinRows;
  const int cap = sizeof(T) == 4 ? kMaxNcF32 : kMaxNcF64;
  int nc = sms / batch;
  if (nc > by_rows) nc = by_rows;
  if (nc > cap) nc = cap;
  return nc < 1 ? 1 : nc;
}

// whether a CTA's block fits in shared memory (the shape alone decides)
template <typename T>
bool block_in_smem(int rpc) {
  return smem_bytes<T>(rpc, true) <= static_cast<size_t>(max_smem_optin());
}

template <typename T>
const void* kernel_for(bool in_smem) {
  return in_smem ? reinterpret_cast<const void*>(qr_panel_kernel<T, true>)
                 : reinterpret_cast<const void*>(qr_panel_kernel<T, false>);
}

// Per device and kernel, once: the dynamic shared memory attribute set to the
// card's opt-in maximum (a launch asks for no more) and the CTAs an SM the
// kernel keeps resident at that size, which no smaller launch lowers.  The
// plan and the launch then cost no driver query.
template <typename T>
cudaError_t prepare(bool in_smem, int* per_sm) {
  static int cached[16][2];  // CTAs an SM; 0: not yet asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* slot = dev < 16 ? &cached[dev][in_smem ? 1 : 0] : nullptr;
  if (slot == nullptr || *slot == 0) {
    const void* fn = kernel_for<T>(in_smem);
    const int optin = max_smem_optin();
    int n = 0;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, optin);
    if (e != cudaSuccess) return e;
    if (slot == nullptr) {
      *per_sm = n;
      return cudaSuccess;
    }
    *slot = n;
  }
  *per_sm = *slot;
  return cudaSuccess;
}

// the scratch layout, in bytes: the flags and the tagged rows (zeroed by
// each launch), then the block products, Y and the global blocks
struct Layout {
  size_t flags, ll, pb, yg, sglob, total;
};

template <typename T>
Layout layout(int batch, int nc, int w, int rpc, bool in_smem) {
  const size_t b = batch, n = nc, ww = w;
  Layout L;
  L.flags = 0;
  L.ll = (b * n * 4 + 15) / 16 * 16;
  L.pb = L.ll + b * (2 * n * kIb + 2 * kIb) * LL<T>::kWords * sizeof(u64);
  L.yg = L.pb + b * n * ww * kIb * sizeof(T);
  L.sglob = L.yg + b * ww * kIb * sizeof(T);
  L.total = L.sglob + (in_smem ? 0 : b * n * rpc * kIb * sizeof(T));
  return L;
}

template <typename T>
int plan(int batch, int m, int w, long long* scratch_elems) {
  if (batch < 1 || batch > kMaxBatch || m < 1 || w < 1 || w > kMaxW) return -1;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess || !coop) return -1;
  const int nc = grid_nc<T>(batch, m, sms);
  const int rpc = (m + nc - 1) / nc;
  const bool in_smem = block_in_smem<T>(rpc);
  if (prepare<T>(in_smem, &per_sm) != cudaSuccess || per_sm < 1) return -1;
  if (static_cast<long long>(batch) * nc > static_cast<long long>(sms) * per_sm) return -1;
  *scratch_elems = static_cast<long long>((layout<T>(batch, nc, w, rpc, in_smem).total + sizeof(T) - 1) / sizeof(T));
  return nc;
}

template <typename T>
int launch(const void* a, void* work, void* v, void* tau, void* t, const int* row0, void* scratch,
           int batch, int m, int w, int nc, int offset, void* stream) {
  if (batch < 1 || batch > kMaxBatch || m < 1 || w < 1 || w > kMaxW || nc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (offset && (row0 == nullptr || v == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Args<T> p;
  p.a = static_cast<const T*>(a);
  p.work = static_cast<T*>(work);
  p.v = static_cast<T*>(v);
  p.tau = static_cast<T*>(tau);
  p.t = static_cast<T*>(t);
  for (int b = 0; b < kMaxBatch; ++b) p.row0[b] = (offset && b < batch) ? row0[b] : 0;
  p.m = m;
  p.w = w;
  p.nc = nc;
  p.rpc = (m + nc - 1) / nc;
  p.offset = offset;
  const auto al16 = [](const void* q) { return q == nullptr || reinterpret_cast<size_t>(q) % 16 == 0; };
  p.vec16 = (static_cast<size_t>(w) * sizeof(T)) % 16 == 0 && al16(a) && al16(work) && al16(v);
  const bool in_smem = block_in_smem<T>(p.rpc);
  const Layout L = layout<T>(batch, nc, w, p.rpc, in_smem);
  char* s = static_cast<char*>(scratch);
  p.flags = reinterpret_cast<unsigned*>(s + L.flags);
  p.pst = reinterpret_cast<u64*>(s + L.ll);
  p.piv = p.pst + static_cast<size_t>(batch) * 2 * nc * kIb * LL<T>::kWords;
  p.pb = reinterpret_cast<T*>(s + L.pb);
  p.yg = reinterpret_cast<T*>(s + L.yg);
  p.sglob = reinterpret_cast<T*>(s + L.sglob);
  const size_t bytes = smem_bytes<T>(p.rpc, in_smem);
  const void* fn = kernel_for<T>(in_smem);
  int per_sm = 0;
  cudaError_t e = prepare<T>(in_smem, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(s, 0, L.pb, st);  // the flags and the tagged rows
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(fn, dim3(batch * nc), dim3(kThreads), args, bytes, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int probe(int batch, int nc, int iters, int mode, void* scratch, void* stream) {
  if (batch < 1 || nc < 1 || nc > kThreads || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout<T>(batch, nc, 1, 1, true);
  char* s = static_cast<char*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(s, 0, L.pb, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned* flags = reinterpret_cast<unsigned*>(s + L.flags);
  u64* ll = reinterpret_cast<u64*>(s + L.ll);
  T* sink = reinterpret_cast<T*>(s + L.pb);
  void* args[] = {&flags, &ll, &nc, &iters, &mode, &sink};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(qr_probe_kernel<T>), dim3(batch * nc),
                                  dim3(kThreads), args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qr_panel_plan_f32(int batch, int m, int w, long long* scratch_elems) {
  return plan<float>(batch, m, w, scratch_elems);
}

extern "C" int qr_panel_plan_f64(int batch, int m, int w, long long* scratch_elems) {
  return plan<double>(batch, m, w, scratch_elems);
}

extern "C" int qr_panel_f32(const void* a, void* work, void* v, void* tau, void* t, const int* row0,
                            void* scratch, int batch, int m, int w, int nc, int offset, void* stream) {
  return launch<float>(a, work, v, tau, t, row0, scratch, batch, m, w, nc, offset, stream);
}

extern "C" int qr_panel_f64(const void* a, void* work, void* v, void* tau, void* t, const int* row0,
                            void* scratch, int batch, int m, int w, int nc, int offset, void* stream) {
  return launch<double>(a, work, v, tau, t, row0, scratch, batch, m, w, nc, offset, stream);
}

// the dynamic shared memory of the launch the plan picks (the block in
// shared memory, or none of it in the global-memory form), in bytes
extern "C" long long qr_panel_smem_bytes(int dsize, int batch, int m, int w) {
  int dev = 0, sms = 0;
  if (batch < 1 || m < 1 || w < 1 || w > kMaxW) return -1;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (dsize == 4) {
    const int nc = grid_nc<float>(batch, m, sms), rpc = (m + nc - 1) / nc;
    return static_cast<long long>(smem_bytes<float>(rpc, block_in_smem<float>(rpc)));
  }
  const int nc = grid_nc<double>(batch, m, sms), rpc = (m + nc - 1) / nc;
  return static_cast<long long>(smem_bytes<double>(rpc, block_in_smem<double>(rpc)));
}

// the probe's scratch: flags, the tagged rows, a sink, in bytes
extern "C" long long qr_probe_scratch_bytes(int dsize, int batch, int nc) {
  if (dsize == 4) return static_cast<long long>(layout<float>(batch, nc, 1, 1, true).pb + 16);
  return static_cast<long long>(layout<double>(batch, nc, 1, 1, true).pb + 16);
}

extern "C" int qr_probe_f32(int batch, int nc, int iters, int mode, void* scratch, void* stream) {
  return probe<float>(batch, nc, iters, mode, scratch, stream);
}

extern "C" int qr_probe_f64(int batch, int nc, int iters, int mode, void* scratch, void* stream) {
  return probe<double>(batch, nc, iters, mode, scratch, stream);
}

#ifdef QR_PROFILE
extern "C" int qr_prof_read(void* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_qr_prof, sizeof(g_qr_prof));
  if (e == cudaSuccess && reset) {
    static long long zero[1024][16];
    e = cudaMemcpyToSymbol(g_qr_prof, zero, sizeof(g_qr_prof));
  }
  return static_cast<int>(e);
}
#endif
