// tile_ops.cu -- the three elementwise / reduction tile kernels on Hopper:
// a batched tile transpose, the tile-stack geadd and the per-tile max |a|.
//
// Replaces: slate_tpu/ops/pallas_ops.py transpose_pallas, geadd_pallas and
// genorm_max_pallas, the TPU kernels that run one grid step per (mb, nb)
// tile of a (k, mb, nb) stack.  Consumers: slate_tpu_torch/ops/tile_ops.py
// transpose (behind ops.kernels.use_cuda_tiles: a CUDA tensor, f32 or bf16,
// 3-D, nb >= 128, k >= 8); geadd and genorm_max have no consumer in the
// package, as in slate_tpu (its tile_ops.geadd / genorm stay plain forms).
//
// What bounds them on this card: bytes.  Each element is read once (twice
// for geadd's two inputs) and written once, with one or two flops per
// element against the H100's 3.35 TB/s: at the (16384, 256, 256) stack
// (4,294,967,296 B in f32, half that in bf16) the bounds are 2.5642 / 1.2821
// ms (transpose, read + write, f32 / bf16), 3.8462 / 1.9231 ms (geadd, 2
// reads + 1 write) and 1.2821 / 0.6410 ms (genorm_max, 1 read).
//
// To run at 3.35 TB/s through ~0.6-0.8 us of loaded DRAM latency the card
// needs 2-3 MB in flight, 16-20 KB an SM.  A thread that moves one 2-byte
// word an access keeps far too little in flight (one word a thread reached
// 36-39% of the bf16 bounds), so the transpose and the max move 16-byte
// vectors and keep several of them in flight a thread.
//
// transpose, two paths, picked on the host by transpose_path() (mirrored by
// ops.kernels.tile_path, which the CPU tests hold):
//   * vec16, when nb and mb are multiples of the 16-byte vector V (8 bf16, 4
//     f32) and both base pointers are 16-byte aligned: every input row and
//     every output row is then a whole number of aligned vectors.  A block
//     is 64 input rows x 128 bytes (64 x 64 bf16, 64 x 32 f32: 8 KB each
//     way); 256 threads load it as 512 16-byte vectors along input rows
//     (eight threads a row, two vectors a thread, both in flight) into
//     shared memory and store it as 512 16-byte vectors along output rows
//     (eight threads a 128-byte run of an output row).  An output vector is
//     V consecutive input rows of one column: bf16 reads it as eight 4-byte
//     words (rows r..r+7, columns c and c+1) and packs two output vectors,
//     for columns c and c+1, with byte permutes; f32 reads four 4-byte
//     words.  Shared memory is 64 rows of eight 16-byte chunks, chunk q of
//     row r stored at q ^ ((r / V) & 7): the eight row groups a warp's
//     column reads touch then sit in eight distinct chunk columns, so every
//     read and every 16-byte write is free of bank conflicts (scalar reads
//     packed into vectors, not ldmatrix.trans: ldmatrix leaves a column's
//     eight rows spread over four lanes, which would need a quad transpose
//     by shuffles; the 4-byte reads already halve the bf16 read count).
//     The grid is resident (SMs x CTAs an SM, asked of the runtime once a
//     device and kernel) and walks the flat list of (stack index, block)
//     pairs, indexed in 64 bits, so no stack the card holds is refused
//     (32-bit divisions while the index fits: 64-bit ones cost the f32
//     full stack 2.7%); each CTA issues its next block's loads before it
//     writes the current one out, so a block's loads are in flight under
//     the previous block's stores.  Edge blocks (nb = 136 against 64) mask
//     whole vectors: with mb and nb multiples of V a vector is either all
//     in the tile or all out.
//   * scalar, for every other stack (rows or a base off 16 bytes): a 32 x 32
//     tile in shared memory with one padding column, 32 x 8 threads, one
//     word an access; the same flat walk over (stack index, block) pairs.
//   Both paths move words as integers, never through float arithmetic, so
//   the result is bitwise the input's, NaN payloads included.  mb != nb
//   works: the output is (k, nb, mb).
//
// geadd: out = alpha a + beta b, grid-stride over the flat stack.  alpha and
//   beta arrive already rounded to the stack's dtype (as slate_tpu's
//   jnp.asarray([alpha], a.dtype)); the sum is formed in the next wider type
//   (f64 for f32, f32 for bf16), where both products are exact, and rounded
//   once.
//
// genorm_max: |a| is the word with its sign bit cleared, and for
//   non-negative IEEE values the unsigned integer order is the float order,
//   with every NaN above +inf: an unsigned max over the words gives the max
//   |a| and propagates NaN (where fmaxf / __hmax / __hmax2 would drop it),
//   and -0.0 reads as +0.0.  Max is exact, so one stage gives slate_tpu's
//   two-stage result (column maxima, then their max), bitwise.  The body of
//   each tile is read as 16-byte vectors, sign-cleared with 0x7fff7fff (bf16
//   pairs) or 0x7fffffff (f32) and folded by __vmaxu2 / an unsigned max,
//   four independent vectors in flight a thread, each into its own
//   accumulator; the two bf16 halves fold at the end.  A tile whose start or
//   end is off 16 bytes (any tile_elems, any base) peels its head and tail,
//   fewer than V words each, as single words inside the same launch.  Work
//   split, passed in by the host (ops.kernels.tile_path, from the tile's
//   bytes): one CTA of 256 threads a tile (the (16384, 256, 256) stack's
//   128 KB tiles), or a warp a tile, eight tiles a CTA, for small tiles
//   ((70000, 2, 128) has 512-byte tiles); the threshold is measured
//   (PERF.md).  The grid is resident and walks the tiles; k is not limited
//   by a grid dimension.
//
// C interface (ctypes), pointers contiguous on the current device, each
// launch returning its CUDA error (0 on success), no synchronisation and no
// allocation:
//   tile_transpose_f32 / _bf16 (a, out, k, mb, nb, stream)
//   tile_geadd_f32 / _bf16 (a, b, out, alpha, beta, n, stream)
//   tile_genorm_max_f32 / _bf16 (a, out, k, tile_elems, split, stream):
//     split 0 a CTA a tile, 1 a warp a tile (the host's choice)
// and the transpose's path rule, for the host to read:
//   tile_transpose_path (a, out, mb, nb, elem_bytes): 0 scalar, 1 vec16

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 32;  // the scalar transpose's block
constexpr int kRows = 8;   // threads per tile column: a 32 x 8 block
constexpr int kVecRows = 64;    // the vec16 transpose's block: 64 input rows
constexpr int kRowBytes = 128;  // of 128 bytes (64 bf16 or 32 f32 columns)
constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks a block row
constexpr int kVecThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kInFlight = 4;  // independent 16-byte loads a max thread keeps in flight
constexpr int kMaxDevices = 64;  // devices whose resident CTA counts are kept

// path codes, shared with ops.kernels.tile_path
constexpr int kTransposeScalar = 0, kTransposeVec16 = 1;
constexpr int kMaxCta = 0, kMaxWarp = 1;

int transpose_path(const void* a, const void* out, long long mb, long long nb, int elem_bytes) {
  const long long v = 16 / elem_bytes;
  const bool whole = mb % v == 0 && nb % v == 0;
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return whole && aligned ? kTransposeVec16 : kTransposeScalar;
}

// the CTAs of Kernel (launched with `threads` threads) the current device
// holds at once, asked of the runtime once a device and then kept (0 on an
// error, which is then cleared: the caller reports it)
template <auto Kernel>
int resident_ctas(int threads, int* err) {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < kMaxDevices) {
    const int n = known[dev].load(std::memory_order_relaxed);
    if (n) return n;
  }
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads, 0);
  if (e != cudaSuccess || sms * per_sm < 1) {
    cudaGetLastError();
    *err = static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    return 0;
  }
  if (dev < kMaxDevices) known[dev].store(sms * per_sm, std::memory_order_relaxed);
  return sms * per_sm;
}

// ---------------------------------------------------------------------------
// transpose: (k, mb, nb) -> (k, nb, mb), moving W-byte words
// ---------------------------------------------------------------------------

// block b of the flat walk: stack index s, first input row r0, first input
// column c0 (blocks of one tile in row-major order)
struct Block {
  long long s;
  int r0, c0;
};

__device__ __forceinline__ Block block_at(long long b, int bm, int bn, int rows, int cols) {
  const int per_tile = bm * bn;  // the launch keeps a tile's blocks within an int
  long long s;
  int rem;
  if (b <= 0x7fffffffLL) {  // 32-bit divisions for every stack under 2^31 blocks
    const int bi = static_cast<int>(b), si = bi / per_tile;
    s = si;
    rem = bi - si * per_tile;
  } else {
    s = b / per_tile;
    rem = static_cast<int>(b - s * per_tile);
  }
  const int br = rem / bn;
  return {s, br * rows, (rem - br * bn) * cols};
}

template <typename W>
__global__ void __launch_bounds__(kTile * kRows)
    transpose_scalar_kernel(const W* __restrict__ a, W* __restrict__ out, int mb, int nb, int bm,
                            int bn, long long total) {
  __shared__ W tile[kTile][kTile + 1];
  const long long stride = static_cast<long long>(mb) * nb;
  for (long long b = blockIdx.x; b < total; b += gridDim.x) {
    const Block blk = block_at(b, bm, bn, kTile, kTile);
    const W* src = a + blk.s * stride;
    W* dst = out + blk.s * stride;
    const int c = blk.c0 + threadIdx.x;
    for (int i = threadIdx.y; i < kTile; i += kRows) {
      const int r = blk.r0 + i;
      if (r < mb && c < nb) tile[i][threadIdx.x] = src[static_cast<long long>(r) * nb + c];
    }
    __syncthreads();
    const int r = blk.r0 + threadIdx.x;
    for (int i = threadIdx.y; i < kTile; i += kRows) {
      const int oc = blk.c0 + i;
      if (oc < nb && r < mb) dst[static_cast<long long>(oc) * mb + r] = tile[threadIdx.x][i];
    }
    __syncthreads();  // the tile is rewritten by the next block
  }
}

// the shared chunk that holds chunk q of block row r: the XOR swizzle puts
// the eight row groups of V rows in eight distinct chunk columns
template <int V>
__device__ __forceinline__ int swizzled(int r, int q) {
  return r * kChunks + (q ^ ((r / V) & (kChunks - 1)));
}

// a block's input as 16-byte vectors, kLoads a thread: vector i = t + 256 u
// is row i / 8, chunk i % 8; vectors off the tile are zero (never stored)
template <typename W, int kLoads>
__device__ __forceinline__ void load_block(const W* __restrict__ a, long long stride, int mb,
                                           int nb, const Block& blk, uint4 (&v)[kLoads]) {
  constexpr int V = 16 / sizeof(W);
  const W* src = a + blk.s * stride;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = threadIdx.x + kVecThreads * u;
    const int r = blk.r0 + i / kChunks, c = blk.c0 + (i % kChunks) * V;
    v[u] = make_uint4(0, 0, 0, 0);
    if (r < mb && c < nb)
      v[u] = __ldg(reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * nb + c));
  }
}

// a block's output rows as 16-byte vectors from the swizzled shared block.
// bf16: thread t (lane l, warp w) writes output rows c and c + 1, c = 8 w +
// 2 (l / 8), at input rows 8 (l % 8) .. + 7; f32: vectors o = t + 256 u,
// g = o / 32, output row c = 4 (g / 2) + l / 8, input rows 4 rg .. + 3 with
// rg = 8 (g % 2) + l % 8.  Either way eight lanes write one 128-byte run of
// an output row, and a warp's column reads hit 32 distinct banks.
template <typename W>
__device__ __forceinline__ void store_block(const uint32_t* __restrict__ sw, W* __restrict__ out,
                                            long long stride, int mb, int nb, const Block& blk) {
  constexpr int V = 16 / sizeof(W);
  constexpr int kWords = kRowBytes / 4;  // 4-byte words a shared row
  W* dst = out + blk.s * stride;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if constexpr (sizeof(W) == 2) {
    const int rg = lane % 8, cp = lane / 8;
    const int c = 8 * warp + 2 * cp;  // its shared chunk is c / 8 = warp
    uint32_t x[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      x[j] = sw[(rg * V + j) * kWords + (warp ^ rg) * 4 + cp];
    const uint4 lo = make_uint4(__byte_perm(x[0], x[1], 0x5410), __byte_perm(x[2], x[3], 0x5410),
                                __byte_perm(x[4], x[5], 0x5410), __byte_perm(x[6], x[7], 0x5410));
    const uint4 hi = make_uint4(__byte_perm(x[0], x[1], 0x7632), __byte_perm(x[2], x[3], 0x7632),
                                __byte_perm(x[4], x[5], 0x7632), __byte_perm(x[6], x[7], 0x7632));
    const int r = blk.r0 + rg * V, oc = blk.c0 + c;
    if (r < mb) {
      W* p = dst + static_cast<long long>(oc) * mb + r;
      if (oc < nb) *reinterpret_cast<uint4*>(p) = lo;
      if (oc + 1 < nb) *reinterpret_cast<uint4*>(p + mb) = hi;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int g = warp + 8 * u;
      const int rg = 8 * (g % 2) + lane % 8, q = g / 2;
      const int c = 4 * q + lane / 8;
      uint32_t x[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        x[j] = sw[(rg * V + j) * kWords + (q ^ (rg % 8)) * 4 + lane / 8];
      const int r = blk.r0 + rg * V, oc = blk.c0 + c;
      if (r < mb && oc < nb)
        *reinterpret_cast<uint4*>(dst + static_cast<long long>(oc) * mb + r) =
            make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kVecThreads)
    transpose_vec_kernel(const W* __restrict__ a, W* __restrict__ out, int mb, int nb, int bm,
                         int bn, long long total) {
  constexpr int V = 16 / sizeof(W);
  constexpr int kCols = kRowBytes / sizeof(W);
  constexpr int kLoads = kVecRows * kChunks / kVecThreads;
  static_assert(kLoads == 2 && kChunks == 8, "the store map assumes 64 x 8 chunks, 256 threads");
  __shared__ uint4 sm[kVecRows * kChunks];
  const long long stride = static_cast<long long>(mb) * nb;
  long long b = blockIdx.x;
  if (b >= total) return;
  Block blk = block_at(b, bm, bn, kVecRows, kCols);
  uint4 v[kLoads];
  load_block<W, kLoads>(a, stride, mb, nb, blk, v);
  for (;;) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = threadIdx.x + kVecThreads * u;
      sm[swizzled<V>(i / kChunks, i % kChunks)] = v[u];
    }
    __syncthreads();
    const long long next = b + gridDim.x;
    Block nxt = blk;
    if (next < total) {  // the next block's loads fly under this block's stores
      nxt = block_at(next, bm, bn, kVecRows, kCols);
      load_block<W, kLoads>(a, stride, mb, nb, nxt, v);
    }
    store_block<W>(reinterpret_cast<const uint32_t*>(sm), out, stride, mb, nb, blk);
    if (next >= total) break;
    __syncthreads();  // the shared block is rewritten by the next block
    b = next;
    blk = nxt;
  }
}

template <typename W>
int launch_transpose(const void* a, void* out, long long k, long long mb, long long nb,
                     void* stream) {
  if (k < 1 || mb < 1 || nb < 1 || mb > (1LL << 30) || nb > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = transpose_path(a, out, mb, nb, sizeof(W)) == kTransposeVec16;
  const long long rows = vec ? kVecRows : kTile, cols = vec ? kRowBytes / sizeof(W) : kTile;
  const long long bm = (mb + rows - 1) / rows, bn = (nb + cols - 1) / cols;
  if (bm * bn > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = k * bm * bn;
  int err = 0;
  const int resident = vec ? resident_ctas<transpose_vec_kernel<W>>(kVecThreads, &err)
                           : resident_ctas<transpose_scalar_kernel<W>>(kTile * kRows, &err);
  if (!resident) return err;
  const unsigned grid = static_cast<unsigned>(total < resident ? total : resident);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    transpose_vec_kernel<W><<<grid, kVecThreads, 0, st>>>(
        static_cast<const W*>(a), static_cast<W*>(out), static_cast<int>(mb),
        static_cast<int>(nb), static_cast<int>(bm), static_cast<int>(bn), total);
  else
    transpose_scalar_kernel<W><<<grid, dim3(kTile, kRows), 0, st>>>(
        static_cast<const W*>(a), static_cast<W*>(out), static_cast<int>(mb),
        static_cast<int>(nb), static_cast<int>(bm), static_cast<int>(bn), total);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// geadd: out = alpha a + beta b, formed in the wider type, rounded once
// ---------------------------------------------------------------------------

__device__ __forceinline__ float axpby(float al, float x, float be, float y) {
  return static_cast<float>(static_cast<double>(al) * x + static_cast<double>(be) * y);
}

__device__ __forceinline__ __nv_bfloat16 axpby(float al, __nv_bfloat16 x, float be,
                                               __nv_bfloat16 y) {
  return __float2bfloat16_rn(al * __bfloat162float(x) + be * __bfloat162float(y));
}

template <typename T>
__global__ void geadd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             T* __restrict__ out, float alpha, float beta, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step)
    out[i] = axpby(alpha, a[i], beta, b[i]);
}

template <typename T>
int launch_geadd(const void* a, const void* b, void* out, double alpha, double beta,
                 long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 32;  // enough CTAs in flight on every SM
  if (blocks > cap) blocks = cap;
  // alpha and beta are already rounded to T: exact as floats
  geadd_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      static_cast<float>(alpha), static_cast<float>(beta), n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// genorm_max: per-tile max |a| as an unsigned max over sign-cleared words
// ---------------------------------------------------------------------------

template <typename W>
struct Bits;
template <>
struct Bits<uint32_t> {
  static constexpr unsigned mask = 0x7fffffffu;  // one f32 a word
  __device__ static unsigned step(unsigned m, unsigned v) { return umax(m, v & mask); }
  __device__ static unsigned fold(unsigned m) { return m; }
};
template <>
struct Bits<uint16_t> {
  static constexpr unsigned mask = 0x7fff7fffu;  // two bf16 a word
  __device__ static unsigned step(unsigned m, unsigned v) { return __vmaxu2(m, v & mask); }
  __device__ static unsigned fold(unsigned m) { return umax(m & 0xffffu, m >> 16); }
};

template <typename W>
__device__ __forceinline__ unsigned max_vec(unsigned m, const uint4& x) {
  return Bits<W>::step(Bits<W>::step(Bits<W>::step(Bits<W>::step(m, x.x), x.y), x.z), x.w);
}

// lane `lane` of `n` threads' max over one tile of T words (its sign-cleared
// words, the bf16 halves folded): the head up to the first 16-byte boundary
// and the tail after the last are single words (fewer than V each, lanes 0..),
// the body 16-byte vectors lane, lane + n, ..., four in flight
template <typename W>
__device__ __forceinline__ unsigned tile_max(const W* __restrict__ tile, long long T, int lane,
                                             int n) {
  constexpr int V = 16 / sizeof(W);
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(tile) % 16) / sizeof(W);
  const long long head = off ? (V - off < T ? V - off : T) : 0;
  const long long nv = (T - head) / V, tail0 = head + nv * V;
  unsigned m0 = 0, m1 = 0, m2 = 0, m3 = 0;
  if (lane < head) m0 = Bits<W>::step(m0, tile[lane]);
  if (lane < T - tail0) m1 = Bits<W>::step(m1, tile[tail0 + lane]);
  const uint4* body = reinterpret_cast<const uint4*>(tile + head);
  long long i = lane;
  for (; i + 3LL * n < nv; i += 4LL * n) {
    const uint4 x0 = __ldg(body + i), x1 = __ldg(body + i + n);
    const uint4 x2 = __ldg(body + i + 2LL * n), x3 = __ldg(body + i + 3LL * n);
    m0 = max_vec<W>(m0, x0);
    m1 = max_vec<W>(m1, x1);
    m2 = max_vec<W>(m2, x2);
    m3 = max_vec<W>(m3, x3);
  }
  for (; i < nv; i += n) m0 = max_vec<W>(m0, __ldg(body + i));
  return Bits<W>::fold(Bits<W>::step(Bits<W>::step(m0, m1), Bits<W>::step(m2, m3)));
}

__device__ __forceinline__ unsigned warp_max(unsigned m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = umax(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// one CTA a tile, the resident grid walking the tiles
template <typename W>
__global__ void __launch_bounds__(kReduceThreads)
    genorm_max_cta_kernel(const W* __restrict__ a, W* __restrict__ out, long long k,
                          long long tile_elems) {
  constexpr int kWarps = kReduceThreads / 32;
  __shared__ unsigned part[2][kWarps];  // two sets: one barrier a tile
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int set = 0;
  for (long long s = blockIdx.x; s < k; s += gridDim.x, set ^= 1) {
    const unsigned m = warp_max(tile_max<W>(a + s * tile_elems, tile_elems, threadIdx.x,
                                            kReduceThreads));
    if (lane == 0) part[set][warp] = m;
    __syncthreads();
    if (warp == 0) {
      const unsigned t = warp_max(lane < kWarps ? part[set][lane] : 0u);
      if (lane == 0) out[s] = static_cast<W>(t);
    }
  }
}

// a warp a tile, eight tiles a CTA, the resident grid walking the tiles
template <typename W>
__global__ void __launch_bounds__(kReduceThreads)
    genorm_max_warp_kernel(const W* __restrict__ a, W* __restrict__ out, long long k,
                           long long tile_elems) {
  constexpr int kWarps = kReduceThreads / 32;
  const int lane = threadIdx.x % 32;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long s = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32; s < k;
       s += step) {
    const unsigned m = warp_max(tile_max<W>(a + s * tile_elems, tile_elems, lane, 32));
    if (lane == 0) out[s] = static_cast<W>(m);
  }
}

template <typename W>
int launch_genorm_max(const void* a, void* out, long long k, long long tile_elems, int split,
                      void* stream) {
  if (k < 1 || tile_elems < 1 || (split != kMaxCta && split != kMaxWarp))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool cta = split == kMaxCta;
  int err = 0;
  const int resident = cta ? resident_ctas<genorm_max_cta_kernel<W>>(kReduceThreads, &err)
                           : resident_ctas<genorm_max_warp_kernel<W>>(kReduceThreads, &err);
  if (!resident) return err;
  const long long want = cta ? k : (k + kReduceThreads / 32 - 1) / (kReduceThreads / 32);
  const unsigned grid = static_cast<unsigned>(want < resident ? want : resident);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cta)
    genorm_max_cta_kernel<W><<<grid, kReduceThreads, 0, st>>>(
        static_cast<const W*>(a), static_cast<W*>(out), k, tile_elems);
  else
    genorm_max_warp_kernel<W><<<grid, kReduceThreads, 0, st>>>(
        static_cast<const W*>(a), static_cast<W*>(out), k, tile_elems);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tile_transpose_f32(const void* a, void* out, long long k, long long mb,
                                  long long nb, void* stream) {
  return launch_transpose<uint32_t>(a, out, k, mb, nb, stream);
}

extern "C" int tile_transpose_bf16(const void* a, void* out, long long k, long long mb,
                                   long long nb, void* stream) {
  return launch_transpose<uint16_t>(a, out, k, mb, nb, stream);
}

extern "C" int tile_geadd_f32(const void* a, const void* b, void* out, double alpha, double beta,
                              long long n, void* stream) {
  return launch_geadd<float>(a, b, out, alpha, beta, n, stream);
}

extern "C" int tile_geadd_bf16(const void* a, const void* b, void* out, double alpha,
                               double beta, long long n, void* stream) {
  return launch_geadd<__nv_bfloat16>(a, b, out, alpha, beta, n, stream);
}

extern "C" int tile_genorm_max_f32(const void* a, void* out, long long k, long long tile_elems,
                                   int split, void* stream) {
  return launch_genorm_max<uint32_t>(a, out, k, tile_elems, split, stream);
}

extern "C" int tile_genorm_max_bf16(const void* a, void* out, long long k, long long tile_elems,
                                    int split, void* stream) {
  return launch_genorm_max<uint16_t>(a, out, k, tile_elems, split, stream);
}

extern "C" int tile_transpose_path(const void* a, const void* out, long long mb, long long nb,
                                   int elem_bytes) {
  return transpose_path(a, out, mb, nb, elem_bytes);
}
