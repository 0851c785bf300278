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
// What bounds it on this card: a panel of m x w moves 2 m w elements at least
// (A in, the factor out; the offset form also writes V) and does ~2 m w^2
// flops, 2 w / 8 = 64 flops per f32 byte at w = 256, 16 at w = 64: the mesh
// panels are bound by operations (67 TFLOP/s), the 64-wide leaves by bytes.
// In practice it is bound by latency: w dependent column steps, each two
// grid-wide reductions.
//
// Design (simple and right first; fast is later work): one cooperative launch
// of co-resident CTAs (cudaLaunchCooperativeKernel, one CTA per SM at most),
// each owning a contiguous block of rows of one panel; the working panel is
// the output buffer (row-major, in global memory, so it stays in the 50 MB
// L2 at the path's sizes: 16 MB for the f32 mesh panel).  Per column step:
//   A. each CTA sums its rows' squares below the pivot (a fixed-order tree);
//      the pivot's owner publishes alpha; grid sync;
//   B. every CTA sums the partial norms in the same order (so all compute
//      the same beta, tau, denom), scales its rows of column j into v, and
//      forms its partial of v^T A over ALL w columns: for k > j that is the
//      row the update needs, for k < j the packed column k holds v_k below
//      its pivot, so the same sum is V[:, :j]^T v_j -- the Gram column T
//      needs, at no extra pass; grid sync;
//   C. every CTA sums the partials of the trailing columns (CTA 0 also those
//      of the Gram column) and updates its rows.
// After the loop, the offset form splits the packed panel into r and v, and
// CTA 0 of each panel runs the T recurrence (thread i owns row i of T).
// Sums over rows and over CTAs have a fixed order: the result does not
// depend on scheduling, but it is not slate_tpu's order (a matmul there), so
// it agrees with the twins to O(m eps), not bitwise.  What it leaves on the
// table: holding each CTA's rows in shared memory, fewer syncs (a look-ahead
// of the next column's norm), blocked (recursive) panels on the tensor cores.
//
// C interface (ctypes), row-major contiguous (batch, m, w) panels on the
// current device, launched on `stream`; no synchronisation, no allocation:
//   qr_panel_plan_f32 / _f64(batch, m, w, &scratch_elems) -> CTAs per panel
//     (or -1): the grid and the scratch the launch needs, in elements of the
//     dtype;
//   qr_panel_f32 / _f64(a, work, v, tau, t, row0, scratch, batch, m, w, nc,
//     offset, stream) -> cudaError_t of the launch.  work: the packed VR
//     (offset = 0) or r (offset = 1); v: the reflectors (offset = 1, else
//     unused); tau (batch, w); t (batch, w, w); row0: batch int32 on the
//     device (offset = 1).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxW = 256;
constexpr int kMinRows = 64;  // rows per CTA at least (fewer CTAs for short panels)

template <typename T>
struct Args {
  const T* a;
  T* work;
  T* v;
  T* tau;
  T* t;
  const int* row0;
  T* part_n;  // (batch, nc) partial norms
  T* alpha;   // (batch) the pivot of the current column
  T* part_s;  // (batch, nc, w) partials of v^T A
  T* gt;      // (batch, w, w): gt[j][k] = v_k^T v_j for k < j
  T* unit;    // (batch, w): the reflector's pivot entry (1, or 0 for a dead offset column)
  int m, w, nc, rpc, offset;
};

template <typename T>
__device__ T block_sum(T x, T* red) {
  const int tid = threadIdx.x;
  red[tid] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) qr_panel_kernel(Args<T> p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red[kThreads];
  __shared__ T srow[kMaxW];
  __shared__ T sc[4];  // tau, denom, unit, R diagonal

  const int tid = threadIdx.x;
  const int panel = blockIdx.x / p.nc, c = blockIdx.x % p.nc;
  const int m = p.m, w = p.w;
  const size_t poff = static_cast<size_t>(panel) * m * w;
  T* W = p.work + poff;
  const int lo = min(m, c * p.rpc), hi = min(m, lo + p.rpc);
  const int r0 = p.offset ? p.row0[panel] : 0;
  const int steps = p.offset ? w : min(m, w);
  const int ngrp = kThreads / w;  // >= 2: w <= 256
  const int col = tid % w, grp = tid / w;
  const bool lane = grp < ngrp;
  T* part_n = p.part_n + static_cast<size_t>(panel) * p.nc;
  T* part_s = p.part_s + static_cast<size_t>(panel) * p.nc * w;
  T* gt = p.gt + static_cast<size_t>(panel) * w * w;

  // 0. this CTA's rows of A into the working panel
  const T* a = p.a + poff;
  for (size_t e = static_cast<size_t>(lo) * w + tid; e < static_cast<size_t>(hi) * w; e += kThreads)
    W[e] = a[e];
  __syncthreads();

  for (int j = 0; j < steps; ++j) {
    const int g = r0 + j;
    // A. partial norm^2 below the pivot; the pivot's owner publishes alpha
    T acc = T(0);
    for (int i = max(lo, g + 1) + tid; i < hi; i += kThreads) {
      const T x = W[static_cast<size_t>(i) * w + j];
      acc += x * x;
    }
    acc = block_sum(acc, red);
    if (tid == 0) {
      part_n[c] = acc;
      if (g >= lo && g < hi) p.alpha[panel] = W[static_cast<size_t>(g) * w + j];
    }
    grid.sync();

    // B. the scalars, the same in every CTA of the panel
    if (tid < 32) {
      T x = T(0);
      for (int cc = tid; cc < p.nc; cc += 32) x += part_n[cc];
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (tid == 0) {
        const T alpha = p.alpha[panel];
        const T anorm = sqrt(alpha * alpha + x);
        const T s = (alpha >= T(0)) ? T(1) : T(-1);
        const bool dead = anorm == T(0);
        const T beta = dead ? T(1) : -s * anorm;
        const T tau = dead ? T(0) : (beta - alpha) / beta;
        T denom = alpha - beta;
        if (denom == T(0)) denom = T(1);
        sc[0] = tau;
        sc[1] = denom;
        sc[2] = (p.offset && dead) ? T(0) : T(1);
        sc[3] = dead ? alpha : beta;
      }
    }
    __syncthreads();
    const T tau = sc[0], denom = sc[1], u = sc[2];
    for (int i = max(lo, g + 1) + tid; i < hi; i += kThreads)
      W[static_cast<size_t>(i) * w + j] = W[static_cast<size_t>(i) * w + j] / denom;
    __syncthreads();
    // partial v^T A over this CTA's rows at and below the pivot (v is 0 above)
    T acc2 = T(0);
    if (lane) {
#pragma unroll 4
      for (int i = max(lo, g) + grp; i < hi; i += ngrp) {
        const T vi = (i == g) ? u : W[static_cast<size_t>(i) * w + j];
        acc2 += vi * W[static_cast<size_t>(i) * w + col];
      }
    }
    red[tid] = acc2;
    __syncthreads();
    if (tid < w) {
      T x = red[tid];
      for (int gg = 1; gg < ngrp; ++gg) x += red[gg * w + tid];
      part_s[static_cast<size_t>(c) * w + tid] = x;
    }
    grid.sync();

    // C. the reduced row (and, in CTA 0, the Gram column), then the update
    if (tid < w) {
      T x = T(0);
#pragma unroll 8
      for (int cc = 0; cc < p.nc; ++cc) x += part_s[static_cast<size_t>(cc) * w + tid];
      srow[tid] = x;
      if (c == 0 && tid < j) gt[static_cast<size_t>(j) * w + tid] = x;
    }
    __syncthreads();
    if (lane && col > j) {
      const T sk = srow[col];
      for (int i = max(lo, g) + grp; i < hi; i += ngrp) {
        const T vi = (i == g) ? u : W[static_cast<size_t>(i) * w + j];
        W[static_cast<size_t>(i) * w + col] -= (tau * vi) * sk;
      }
    }
    if (tid == 0 && g >= lo && g < hi) W[static_cast<size_t>(g) * w + j] = sc[3];
    if (c == 0 && tid == 0) {
      p.tau[static_cast<size_t>(panel) * w + j] = tau;
      p.unit[static_cast<size_t>(panel) * w + j] = u;
    }
    __syncthreads();  // red, srow and sc are reused by the next step
  }
  grid.sync();  // every column final; tau, unit and gt written

  // the offset form: r keeps rows <= the pivot, v the rows below, the unit entry
  if (p.offset) {
    T* V = p.v + poff;
    const T* unit = p.unit + static_cast<size_t>(panel) * w;
    for (size_t e = static_cast<size_t>(lo) * w + tid; e < static_cast<size_t>(hi) * w; e += kThreads) {
      const int i = static_cast<int>(e / w), k = static_cast<int>(e % w);
      const int gk = r0 + k;
      if (i > gk) {
        V[e] = W[e];
        W[e] = T(0);
      } else {
        V[e] = (i == gk) ? unit[k] : T(0);
      }
    }
  }

  // T, by CTA 0 of the panel: thread i owns row i and reads only its own row
  if (c == 0) {
    T* t = p.t + static_cast<size_t>(panel) * w * w;
    T* tau_out = p.tau + static_cast<size_t>(panel) * w;
    for (int j = 0; j < w; ++j) {
      if (tid < j && j < steps) srow[tid] = gt[static_cast<size_t>(j) * w + tid];
      __syncthreads();
      if (tid < w) {
        const int i = tid;
        const T tj = j < steps ? tau_out[j] : T(0);
        T val = T(0);
        if (i < j) {
          if (j < steps) {
            T x = T(0);
            for (int k = i; k < j; ++k) x += t[static_cast<size_t>(i) * w + k] * srow[k];
            val = -tj * x;
          }
        } else if (i == j) {
          val = tj;
        }
        t[static_cast<size_t>(i) * w + j] = val;
        if (i == j && j >= steps) tau_out[j] = T(0);
      }
      __syncthreads();
    }
  }
}

template <typename T>
int plan(int batch, int m, int w, long long* scratch_elems) {
  if (batch < 1 || m < 1 || w < 1 || w > kMaxW) return -1;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess || !coop) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qr_panel_kernel<T>, kThreads, 0) != cudaSuccess ||
      per_sm < 1)
    return -1;
  const int by_rows = (m + kMinRows - 1) / kMinRows;
  int nc = sms / batch;
  if (nc > by_rows) nc = by_rows;
  if (nc < 1) nc = 1;
  if (static_cast<long long>(batch) * nc > static_cast<long long>(sms) * per_sm) return -1;
  const long long b = batch, n = nc, ww = w;
  *scratch_elems = b * n + b + b * n * ww + b * ww * ww + b * ww;
  return nc;
}

template <typename T>
int launch(const void* a, void* work, void* v, void* tau, void* t, const void* row0, void* scratch,
           int batch, int m, int w, int nc, int offset, void* stream) {
  if (batch < 1 || m < 1 || w < 1 || w > kMaxW || nc < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (offset && (row0 == nullptr || v == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Args<T> p;
  p.a = static_cast<const T*>(a);
  p.work = static_cast<T*>(work);
  p.v = static_cast<T*>(v);
  p.tau = static_cast<T*>(tau);
  p.t = static_cast<T*>(t);
  p.row0 = static_cast<const int*>(row0);
  T* s = static_cast<T*>(scratch);
  const size_t b = batch, n = nc, ww = w;
  p.part_n = s;
  p.alpha = p.part_n + b * n;
  p.part_s = p.alpha + b;
  p.gt = p.part_s + b * n * ww;
  p.unit = p.gt + b * ww * ww;
  p.m = m;
  p.w = w;
  p.nc = nc;
  p.rpc = (m + nc - 1) / nc;
  p.offset = offset;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)qr_panel_kernel<T>,
                                              dim3(batch * nc), dim3(kThreads), args, 0,
                                              static_cast<cudaStream_t>(stream));
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

extern "C" int qr_panel_f32(const void* a, void* work, void* v, void* tau, void* t, const void* row0,
                            void* scratch, int batch, int m, int w, int nc, int offset, void* stream) {
  return launch<float>(a, work, v, tau, t, row0, scratch, batch, m, w, nc, offset, stream);
}

extern "C" int qr_panel_f64(const void* a, void* work, void* v, void* tau, void* t, const void* row0,
                            void* scratch, int batch, int m, int w, int nc, int offset, void* stream) {
  return launch<double>(a, work, v, tau, t, row0, scratch, batch, m, w, nc, offset, stream);
}
