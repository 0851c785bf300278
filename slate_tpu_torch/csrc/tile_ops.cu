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
// element against the H100's 3.35 TB/s: at the (16384, 256, 256) f32 stack
// (4,294,967,296 B) the bounds are 2.564 ms (transpose, read + write),
// 3.846 ms (geadd, 2 reads + 1 write) and 1.282 ms (genorm_max, 1 read).
//
// Design (simple and right first; fast is later work):
//   * transpose: a 32 x 32 tile in shared memory with one padding column
//     (no bank conflicts on the column read), 32 x 8 threads; reads run along
//     a row of the input and writes along a row of the output, so both are
//     coalesced.  Grid (tiles of nb, tiles of mb, stack), the stack index
//     striding by gridDim.z past 65535.  mb != nb works: the output is
//     (k, nb, mb).  The kernel moves bits (a 4- or 2-byte word), so the
//     result is bitwise the input's.
//   * geadd: out = alpha a + beta b, grid-stride over the flat stack.  alpha
//     and beta arrive already rounded to the stack's dtype (as slate_tpu's
//     jnp.asarray([alpha], a.dtype)); the sum is formed in the next wider
//     type (f64 for f32, f32 for bf16), where both products are exact, and
//     rounded once.
//   * genorm_max: one CTA per tile.  |a| is the word with its sign bit
//     cleared, and for non-negative IEEE values the unsigned integer order
//     is the float order, with every NaN above +inf: an unsigned max over
//     the words gives the max |a| and propagates NaN (where fmaxf / __hmax
//     would drop it), and -0.0 reads as +0.0.  Per thread a strided max,
//     then a warp shuffle max and one over the warps in shared memory.
//     Max is exact, so this one stage gives slate_tpu's two-stage result.
//
// C interface (ctypes), pointers contiguous on the current device, each
// returning cudaGetLastError() after its launch (0 on success), no
// synchronisation and no allocation:
//   tile_transpose_f32 / _bf16 (a, out, k, mb, nb, stream)
//   tile_geadd_f32 / _bf16 (a, b, out, alpha, beta, n, stream)
//   tile_genorm_max_f32 / _bf16 (a, out, k, tile_elems, stream)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // threads per tile column: a 32 x 8 block
constexpr int kMaxGridZ = 65535;
constexpr int kReduceThreads = 256;

// ---------------------------------------------------------------------------
// transpose: (k, mb, nb) -> (k, nb, mb), moving W-byte words
// ---------------------------------------------------------------------------

template <typename W>
__global__ void transpose_kernel(const W* __restrict__ a, W* __restrict__ out, long long k,
                                 int mb, int nb) {
  __shared__ W tile[kTile][kTile + 1];
  const int r0 = blockIdx.y * kTile;  // input rows (output columns)
  const int c0 = blockIdx.x * kTile;  // input columns (output rows)
  const long long stride = static_cast<long long>(mb) * nb;
  for (long long s = blockIdx.z; s < k; s += gridDim.z) {
    const W* src = a + s * stride;
    W* dst = out + s * stride;
    const int c = c0 + threadIdx.x;
    for (int i = threadIdx.y; i < kTile; i += kRows) {
      const int r = r0 + i;
      if (r < mb && c < nb) tile[i][threadIdx.x] = src[static_cast<long long>(r) * nb + c];
    }
    __syncthreads();
    const int r = r0 + threadIdx.x;
    for (int i = threadIdx.y; i < kTile; i += kRows) {
      const int oc = c0 + i;
      if (oc < nb && r < mb) dst[static_cast<long long>(oc) * mb + r] = tile[threadIdx.x][i];
    }
    __syncthreads();  // the tile is rewritten by the next stack index
  }
}

template <typename W>
int launch_transpose(const void* a, void* out, long long k, long long mb, long long nb,
                     void* stream) {
  if (k < 1 || mb < 1 || nb < 1 || mb > (1LL << 30) || nb > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long gy = (mb + kTile - 1) / kTile;
  if (gy > kMaxGridZ) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>((nb + kTile - 1) / kTile), static_cast<unsigned>(gy),
            static_cast<unsigned>(k < kMaxGridZ ? k : kMaxGridZ));
  dim3 block(kTile, kRows);
  transpose_kernel<W><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(a), static_cast<W*>(out), k, static_cast<int>(mb),
      static_cast<int>(nb));
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
  static constexpr unsigned mask = 0x7fffffffu;
};
template <>
struct Bits<uint16_t> {
  static constexpr unsigned mask = 0x7fffu;
};

template <typename W>
__global__ void genorm_max_kernel(const W* __restrict__ a, W* __restrict__ out,
                                  long long tile_elems) {
  const W* src = a + static_cast<long long>(blockIdx.x) * tile_elems;
  unsigned m = 0;
  for (long long i = threadIdx.x; i < tile_elems; i += blockDim.x) {
    const unsigned v = static_cast<unsigned>(src[i]) & Bits<W>::mask;
    m = v > m ? v : m;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned o = __shfl_down_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  __shared__ unsigned warp_max[kReduceThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kReduceThreads / 32; ++w) m = warp_max[w] > m ? warp_max[w] : m;
    out[blockIdx.x] = static_cast<W>(m);
  }
}

template <typename W>
int launch_genorm_max(const void* a, void* out, long long k, long long tile_elems,
                      void* stream) {
  if (k < 1 || tile_elems < 1 || k > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  genorm_max_kernel<W><<<static_cast<unsigned>(k), kReduceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(a), static_cast<W*>(out), tile_elems);
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
                                   void* stream) {
  return launch_genorm_max<uint32_t>(a, out, k, tile_elems, stream);
}

extern "C" int tile_genorm_max_bf16(const void* a, void* out, long long k, long long tile_elems,
                                    void* stream) {
  return launch_genorm_max<uint16_t>(a, out, k, tile_elems, stream);
}
