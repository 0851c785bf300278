// matmul.cu -- C = A B with the products summed in f32, on Hopper's tensor cores (sm_90a).
//
// Replaces: slate_tpu/ops/matmul.py:73 matmul_pallas (its pallas_call at :86),
// the TPU's blocked GEMM over a (M/bm, N/bn, K/bk) grid with an f32 VMEM
// accumulator and precision HIGHEST.  Wrapper: slate_tpu_torch/ops/kernels.py
// matmul_pallas (its plain twin matmul_pallas_plain; the per-operand layout
// plan matmul_operand_plan); public entry slate_tpu_torch/ops/matmul.py
// matmul_pallas.  As in slate_tpu, no driver reaches it: the default
// dispatch (_use_pallas) never takes it.
//
// What it computes is the TPU kernel's function, not its block structure:
// C (m x n) = A (m x k) B (k x n), products summed in f32 accumulators, C
// written in A's dtype (rounded once, to nearest even).  bf16 and f16
// operands go to the tensor cores as they are.  f32 operands are computed
// as the TPU's HIGHEST computes them (XLA's bf16_6x on the MXU): each value
// is split into three bf16 planes, x = x0 + x1 + x2, and the six plane
// products x0y0, x0y1, x1y0, x0y2, x1y1, x2y0 are summed in f32; the three
// dropped ones (x1y2, x2y1, x2y2) are below 2^-21 |x y| each.  No TF32.
// f64 and complex are refused by the wrapper (the TPU kernel takes neither).
//
// The split (pack_kernel): each plane is the leading 8 significant bits of
// what the planes before it left, rounded toward zero (the top 16 bits of
// the f32 word).  So every subtraction is exact, every plane has x's sign
// (or is zero), and x0 never overflows.  For finite |x| >= 2^-110 the planes
// add back to x exactly (x2 may be a bf16 subnormal there; below 2^-110 its
// lowest bits fall under bf16's subnormal spacing, 2^-133, and are lost).
// NaN and +-inf go whole into x0 with zero planes below: NaN propagates as
// in the twin, but an inf meets the other operand's zero lower planes, so
// where the twin reads +-inf the kernel may read NaN (0 * inf) when the
// other operand's value is exact in bf16.
//
// What bounds it on this card: operations.  2 m n k flops against
// (m k + k n + m n) elements (1365 flops a byte at 8192^3 f32).  The tensor
// cores' dense bf16/f16 rate is 989 TFLOP/s: 2 m n k / 989e12 s (1.112 ms at
// 8192^3) for bf16/f16, six such passes for f32 (6.67 ms at 8192^3; the CUDA
// cores' FFMA bound would be 16.4 ms).  The pack passes are HBM-bound.
//
// Design.  One GEMM core on wgmma, fed by TMA:
// - operands through swizzled TMA tensor maps, which zero-fill the ragged
//   k, m and n edges: A K-major ((m, k), k contiguous, a 3-D map
//   (k, m, plane)); B K-major ((n, k), k contiguous) or, for a row-major B
//   (n contiguous), MN-major as it lies (a map (n, k), BN / 64 boxes of
//   64 n x 64 k a stage, wgmma's transposed-B form), so the common
//   row-major B needs no copy.  An operand of any other layout, stride or
//   alignment (and every f32 operand) is first written K-major by the pack
//   kernel into scratch the wrapper allocates (row stride k rounded up to 8
//   elements); the wrapper's matmul_operand_plan decides, per operand.
// - a persistent grid (one CTA an SM) walks the C tiles in grouped order
//   (kGroupM tile rows at a time, so neighbouring CTAs share B in L2).  A CTA
//   is three warpgroups: two consumers (64 C rows each) and one producer,
//   whose one thread keeps TMA loads in flight through a ring of kStages
//   shared-memory stages, each with a full and an empty mbarrier;
//   setmaxnreg moves registers from the producer (40) to the consumers (232).
//   The producer runs ahead into the next tile while the consumers store C.
// - a stage holds a k slab of A (128 rows) and of B (BN rows).  bf16/f16:
//   BN = 256, 64 deep (128-byte swizzle), four stages; a consumer issues four
//   m64n256k16 wgmma a stage.  f32: BN = 128, all three planes of A and of
//   B in one stage; a consumer issues the six plane pairs in the order of
//   kPlaneA / kPlaneB (smallest first), KD / 16 m64n128k16 wgmma each.  The
//   depth KD follows k: 32 deep (64-byte swizzle, four stages of 48 KB)
//   where k > kF32DeepK, 64 deep (128-byte swizzle, two stages of 96 KB) up
//   to it.  On the H100 four stages ran faster at 8192^3 and two at the
//   thin-k shape (k = 256; PERF.md).  A consumer keeps one stage's products
//   in flight.  Loading all three planes once a stage halves the L2 traffic
//   of a stage per plane pair (which reloads a plane for each pair that
//   uses it, and measured slower).
// - f32 accumulation: the tensor cores truncate as they accumulate, so over
//   a long k the f32 form drifts: each 64-deep k slab's six products are
//   summed in their own accumulators and added (round to nearest) into a
//   second f32 sum, which is why its C tile is 128 wide (two register sets
//   of 64).  At 8192^3 the error from the f64 product reads 0.59 eps32
//   max(|A||B|) against the cuBLAS twin's 0.43 (H100).  bf16/f16 outputs round once
//   at the end, which dwarfs that drift.
// - each output element sums its k slabs in k order; no split-k, no
//   atomics, so a call gives the same bits run to run.  The epilogue stores
//   from registers, masked at the ragged m and n edges: f32 as 8-byte
//   column pairs; bf16/f16 after a shuffle within each quad of lanes as one
//   16-byte streaming store a lane (the thin-k shape writes 2 GB of C).
//
// Tolerance against the twin (utils.testing.matmul_pallas_excess, in f64 on
// the card): |C - C_twin| <= 9 sqrt(k) eps32 (|A||B|) elementwise, the two
// f32 sums taken in different orders, each within Higham and Mary's
// probabilistic bound lambda sqrt(k) u (|A||B|), lambda = 9; a bf16/f16
// output adds one ulp of its dtype.  The dropped plane products add at most
// 2^-21 (|A||B|).  Not bitwise.  That tolerance passes a C that leaves out a
// plane pair, so the f32 form is also held to the six plane products it
// sums (utils.testing.matmul_split6_reading: within MATMUL_SPLIT6_LIMIT of
// the smallest second-order pair product's largest entry).
//
// C interface (ctypes), each returning 0 or an error (a CUDA error, or
// -1 - CUresult of the tensor-map encoder, or -1 when no CUDA driver is
// found), no synchronisation, no allocation:
//   matmul_pack(dtype, src, dst, rows, k, s_row, s_k, ld, ps, stream):
//     dst[p][r][kk] = plane p of src[r * s_row + kk * s_k] (dtype 0: f32 ->
//     three bf16 planes; 1: bf16 -> bf16; 2: f16 -> f16), r < rows, kk < k,
//     plane stride ps and row stride ld elements;
//   matmul_core(dtype, a, a_ld, a_ps, b, b_ld, b_ps, b_mn, c, m, n, k, stream):
//     C (m x n, row-major, contiguous, A's dtype) from the K-major forms of
//     A (m rows) and B (n rows; with b_mn, a 16-bit row-major (k, n) B as it
//     lies, k rows of stride b_ld) at row stride *_ld and plane stride *_ps
//     (three planes for dtype 0, else one); k = 0 writes zeros;
//   matmul_core_smem(dtype, k): the core's dynamic shared memory in bytes.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in the driver
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;                   // C tile rows: two consumer warpgroups of 64
constexpr int kConsumers = 2;             // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kGroupM = 16;               // grouped tile order: tile rows a group
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// the f32 form's six plane pairs (A plane, B plane), in the order summed
__constant__ int kPlaneA[6] = {2, 1, 0, 1, 0, 0};
__constant__ int kPlaneB[6] = {0, 1, 2, 0, 1, 0};

// A stage: PLANES planes of a BM x KD slab of A and of a BN x KD slab of B,
// each K-major with rows of 2 KD bytes (the swizzle span: 128 or 64 bytes);
// as many stages as fit 192 KB
template <int BN, int PLANES, int KD>
struct Cfg {
  static constexpr int kSwizzle = 2 * KD;
  static constexpr int kATile = BM * KD * 2;
  static constexpr int kBTile = BN * KD * 2;
  static constexpr int kStageBytes = PLANES * (kATile + kBTile);
  static constexpr int kStages = 192 * 1024 / kStageBytes;
  // stages, 1 KB to align them to the swizzle atom, full and empty barriers
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};
using CfgHalf = Cfg<256, 1, 64>;    // bf16 / f16: 128 x 256 tiles, 64 deep, 4 stages
using CfgF32 = Cfg<128, 3, 32>;     // f32 planes: 128 x 128 tiles, 32 deep, 4 stages
using CfgF32Deep = Cfg<128, 3, 64>; // the same, 64 deep, 2 stages: for k <= kF32DeepK
constexpr long long kF32DeepK = 256;

// the 128 accumulator operands of an m64n256k16 product, as PTX names and as constraints
#define WGMMA_REGS_N256 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define WGMMA_OUTS_N256(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// the 64 accumulator operands of an m64n128k16 product, as PTX names and as constraints
#define WGMMA_REGS_N128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WGMMA_OUTS_N128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

template <int N, typename T, int TB>
struct Wgmma;

// one m64nNk16 product of 16-bit operands in shared memory (descriptors da,
// db; A K-major, B K-major (TB = 0) or MN-major (TB = 1)), added to d
// (scale_d = 1) or written to it (scale_d = 0)
#define DEFINE_WGMMA(N, CTY, TY, IA, IB, IS, IT)                                             \
  template <int TB>                                                                          \
  struct Wgmma<N, CTY, TB> {                                                                 \
    static __device__ __forceinline__ void run(float (&d)[N / 2], uint64_t da, uint64_t db, \
                                               int scale_d) {                                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                         \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY               \
                   " {" WGMMA_REGS_N##N "}, %" #IA ", %" #IB ", p, 1, 1, 0, %" #IT ";\n}\n"  \
                   : WGMMA_OUTS_N##N(d)                                                      \
                   : "l"(da), "l"(db), "r"(scale_d), "n"(TB));                              \
    }                                                                                        \
  };
DEFINE_WGMMA(256, __nv_bfloat16, "bf16", 128, 129, 130, 131)
DEFINE_WGMMA(256, __half, "f16", 128, 129, 130, 131)
DEFINE_WGMMA(128, __nv_bfloat16, "bf16", 64, 65, 66, 67)
#undef DEFINE_WGMMA

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of the accumulators across a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// an SW-byte swizzled operand tile in shared memory (SW = 128 or 64): rows of
// SW bytes in 8-row atoms of 8 SW bytes (SBO, the stride between atoms along
// the rows).  K-major: a row is SW / 2 k of one m or n, the leading offset
// (LBO) unused.  MN-major (SW = 128): a row is 64 n of one k, the k atoms
// 1024 bytes apart and the 64-wide n blocks lbo bytes apart (LBO).
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo = 16) {
  constexpr uint64_t kLayout = SW == 128 ? 1 : 2;  // the descriptor's swizzle mode
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(8 * SW >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// tile t of the grouped order: kGroupM tile rows at a time, column by column
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int first = t / per_group * kGroupM;
  const int size = min(tiles_m - first, kGroupM);
  const int r = t % per_group;
  tm = first + r % size;
  tn = r / size;
}

template <typename Out>
__device__ __forceinline__ uint32_t pack2(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  const __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// word i of four, chosen by a run-time index without indexing registers
__device__ __forceinline__ uint32_t pick4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3, int i) {
  return i == 0 ? w0 : i == 1 ? w1 : i == 2 ? w2 : w3;
}

// 16-bit C: the four lanes of a quad trade their column pairs so that lane q
// holds the 8 columns of n8 block 4 g + q, and stores them as one 16-byte word
// (streaming: C is not read again), so a warp writes 64 contiguous bytes a row
// (a 4-byte column pair a lane left the thin-k shape bound by its stores)
template <typename Out, int BN>
__device__ __forceinline__ void store_quads(Out* c, const float (&acc)[BN / 2], int row, int col_tile,
                                            int q, int m, int n) {
  const bool vec = (n & 7) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
#pragma unroll
    for (int g = 0; g < BN / 32; ++g) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = pack2<Out>(acc[4 * (4 * g + i) + 2 * h], acc[4 * (4 * g + i) + 2 * h + 1]);
      uint32_t o0 = 0, o1 = 0, o2 = 0, o3 = 0;  // o_s: lane s's pair of block 4 g + q
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int partner = q ^ t;
        const uint32_t send = pick4(w[0], w[1], w[2], w[3], partner);
        const uint32_t got = t == 0 ? send : __shfl_xor_sync(0xffffffffu, send, t);
        o0 = partner == 0 ? got : o0;
        o1 = partner == 1 ? got : o1;
        o2 = partner == 2 ? got : o2;
        o3 = partner == 3 ? got : o3;
      }
      const int col = col_tile + 8 * (4 * g + q);
      if (r >= m || col >= n) continue;
      Out* p = c + static_cast<int64_t>(r) * n + col;
      if (vec && col + 8 <= n) {
        __stcs(reinterpret_cast<uint4*>(p), make_uint4(o0, o1, o2, o3));
      } else {
        const uint32_t o[4] = {o0, o1, o2, o3};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < n) {
            const uint32_t word = o[e / 2];
            const unsigned short bits = static_cast<unsigned short>(e % 2 ? word >> 16 : word & 0xffff);
            *reinterpret_cast<unsigned short*>(p + e) = bits;
          }
      }
    }
  }
}

// f32 C: the thread's column pair (x, y) at off; as one 8-byte word where n is
// even, else one value at a time (y only if it lies inside C)
__device__ __forceinline__ void store_f32_pair(float* c, int64_t off, bool pair_ok, bool second,
                                               float x, float y) {
  if (pair_ok) {
    *reinterpret_cast<float2*>(c + off) = make_float2(x, y);
  } else {
    c[off] = x;
    if (second) c[off + 1] = y;
  }
}

// The GEMM core.  In: the 16-bit operand type; Out: C's type; BN: C tile
// columns; PLANES: planes of A and of B a stage (3 for f32, whose six plane
// pairs are summed stage by stage and promoted into a second sum every 64 k;
// else 1); KD: k depth of a stage; B_MN: B read as it lies in a row-major
// (k, n) tensor (n contiguous: BN / 64 boxes of 64 n x KD k a stage) instead
// of K-major.
template <typename In, typename Out, int BN, int PLANES, int KD, bool B_MN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                Out* __restrict__ c, int m, int n, int ktiles) {
  using C = Cfg<BN, PLANES, KD>;
  constexpr bool kPromote = PLANES == 3;
  constexpr int kPairs = PLANES == 3 ? 6 : 1;
  constexpr int kSlab = 64 / KD;  // stages a promoted sum
  constexpr int kRegs = BN / 2;   // accumulators a thread: m64 x BN over 128 threads
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t full0 = base + C::kStages * C::kStageBytes;  // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * C::kStages;             // empty[s] = empty0 + 8 s
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                    // the producer's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers * 4);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const int ntiles = tiles_m * tiles_n;
  const int wg = tid / 128;

  if (wg == kConsumers) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int tm, tn;
        tile_coords(t, tiles_m, tiles_n, tm, tn);
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage, sa = base + stage * C::kStageBytes;
          const uint32_t sb = sa + PLANES * C::kATile;
          mbar_expect_tx(full, C::kStageBytes);
#pragma unroll
          for (int p = 0; p < PLANES; ++p) tma_load(sa + p * C::kATile, &map_a, full, kt * KD, tm * BM, p);
          if constexpr (B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(sb + j * 64 * KD * 2, &map_b, full, tn * BN + 64 * j, kt * KD, 0);
          } else {
#pragma unroll
            for (int p = 0; p < PLANES; ++p)
              tma_load(sb + p * C::kBTile, &map_b, full, kt * KD, tn * BN, p);
          }
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns C rows [64 wg, 64 wg + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = tid % 32, warp = (tid % 128) / 32;
    float acc[kRegs];
    float sum[kPromote ? kRegs : 1];  // the f32 form's sum of its 64-deep slabs
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int tm, tn;
      tile_coords(t, tiles_m, tiles_n, tm, tn);
#pragma unroll
      for (int i = 0; i < kRegs; ++i) acc[i] = 0.0f;
      if constexpr (kPromote) {
#pragma unroll
        for (int i = 0; i < kRegs; ++i) sum[i] = 0.0f;
      }
      int pending = -1;  // the stage whose products may still be in flight
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * C::kStageBytes;
        const uint32_t sb = sa + PLANES * C::kATile;
        const bool fresh = kPromote ? kt % kSlab == 0 : kt == 0;  // the first product of a sum
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          const int pa = PLANES == 1 ? 0 : kPlaneA[p], pb = PLANES == 1 ? 0 : kPlaneB[p];
          const uint64_t da = smem_desc<C::kSwizzle>(sa + pa * C::kATile + wg * 64 * KD * 2);
          const uint64_t db = B_MN ? smem_desc<128>(sb, 64 * KD * 2)
                                   : smem_desc<C::kSwizzle>(sb + pb * C::kBTile);
#pragma unroll
          for (int kk = 0; kk < KD / 16; ++kk)  // 16 deep a product: 32 bytes along a K-major
            Wgmma<BN, In, B_MN>::run(             // row, 16 rows of 128 bytes down an MN-major tile
                acc, da + 2 * kk, db + (B_MN ? 128 : 2) * kk, fresh && p == 0 && kk == 0 ? 0 : 1);
        }
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();  // all but this stage's products are done
        if (pending >= 0 && lane == 0) mbar_arrive(empty0 + 8 * pending);
        pending = stage;
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
        if constexpr (kPromote) {
          if (kt % kSlab == kSlab - 1 || kt == ktiles - 1) {
            wgmma_wait<0>();
            fence_regs(acc);
            if (lane == 0) mbar_arrive(empty0 + 8 * pending);
            pending = -1;
#pragma unroll
            for (int i = 0; i < kRegs; ++i) sum[i] += acc[i];
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (pending >= 0 && lane == 0) mbar_arrive(empty0 + 8 * pending);
      if constexpr (kPromote) {
#pragma unroll
        for (int i = 0; i < kRegs; ++i) acc[i] = sum[i];
      }

      // epilogue: thread (warp, lane) holds rows r and r + 8, column pairs
      // 8 j + 2 (lane % 4) of the n8 blocks j
      const int row = tm * BM + wg * 64 + warp * 16 + lane / 4;
      if constexpr (sizeof(Out) == 2) {
        store_quads<Out, BN>(c, acc, row, tn * BN, lane % 4, m, n);
      } else {
        const int col0 = tn * BN + 2 * (lane % 4);
        const bool even_n = (n & 1) == 0;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = col0 + 8 * j;
          if (col >= n) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row + 8 * h;
            if (r >= m) continue;
            const bool second = col + 1 < n;
            store_f32_pair(c, static_cast<int64_t>(r) * n + col, second && even_n, second,
                           acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the pack: any strided operand -> K-major 16-bit planes
// ---------------------------------------------------------------------------

constexpr int kPackRows = 32, kPackK = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ uint32_t top16(float x) { return __float_as_uint(x) >> 16; }
__device__ __forceinline__ float trunc16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// plane p (of PLANES) of x as a 16-bit word: the three-plane split of an f32
// value (see the note at the top), or the value itself in 16 bits
template <typename Src, int PLANES>
__device__ __forceinline__ uint32_t plane_bits(float x, int p) {
  if constexpr (PLANES == 1) {
    if constexpr (std::is_same<Src, __half>::value) return __half_as_ushort(__float2half_rn(x));
    else return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  } else {
    if (!isfinite(x)) return p ? 0u : (isnan(x) ? 0x7fc0u : top16(x));
    const float x0 = trunc16(x);
    if (p == 0) return top16(x0);
    const float r1 = x - x0;  // exact: x and x0 share sign and exponent
    const float x1 = trunc16(r1);
    return p == 1 ? top16(x1) : top16(trunc16(r1 - x1));
  }
}

// one CTA of 32 x 8 threads packs a 32-row x 64-deep block through shared
// memory: loads run along whichever of k and the rows is contiguous (k_fast),
// stores along k, two values a thread a row
template <typename Src, int PLANES>
__global__ void __launch_bounds__(256)
    pack_kernel(const Src* __restrict__ src, uint16_t* __restrict__ dst, int64_t rows, int64_t k,
                int64_t s_row, int64_t s_k, int64_t ld, int64_t ps, int k_fast) {
  __shared__ float tile[kPackRows][kPackK + 1];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kPackRows;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kPackK;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  if (k_fast) {
#pragma unroll
    for (int i = 0; i < kPackRows / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ty + 8 * i, kk = tx + 32 * h;
        const bool in = r0 + r < rows && k0 + kk < k;
        tile[r][kk] = in ? to_f32(src[(r0 + r) * s_row + (k0 + kk) * s_k]) : 0.0f;
      }
  } else {
#pragma unroll
    for (int i = 0; i < kPackK / 8; ++i) {
      const int r = tx, kk = ty + 8 * i;
      const bool in = r0 + r < rows && k0 + kk < k;
      tile[r][kk] = in ? to_f32(src[(r0 + r) * s_row + (k0 + kk) * s_k]) : 0.0f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPackRows / 8; ++i) {
    const int r = ty + 8 * i, kk = 2 * tx;
    if (r0 + r >= rows || k0 + kk >= k) continue;
    const float x = tile[r][kk], y = tile[r][kk + 1];  // y is 0 past k (ld > k there)
    const int64_t off = (r0 + r) * ld + k0 + kk;
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
      *reinterpret_cast<uint32_t*>(dst + p * ps + off) =
          plane_bits<Src, PLANES>(x, p) | (plane_bits<Src, PLANES>(y, p) << 16);
  }
}

template <typename Src, int PLANES>
int launch_pack(const void* src, void* dst, long long rows, long long k, long long s_row,
                long long s_k, long long ld, long long ps, void* stream) {
  if (rows < 0 || k < 0 || ld < k || ld % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || k == 0) return 0;
  const long long gx = (rows + kPackRows - 1) / kPackRows, gy = (k + kPackK - 1) / kPackK;
  if (gx > 0x7fffffffLL || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  pack_kernel<Src, PLANES><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Src*>(src), static_cast<uint16_t*>(dst), rows, k, s_row, s_k, ld, ps,
      s_k <= s_row ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// host side of the core: tensor maps and the launch
// ---------------------------------------------------------------------------

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process already has loaded
EncodeFn encoder() {
  static const EncodeFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// the (inner, outer, planes) map of an operand whose inner index is
// contiguous (k of a K-major operand, n of an MN-major B), row stride ld and
// plane stride ps elements, boxes of box_inner x box_outer x 1, box rows
// swizzled over their 2 box_inner bytes (128 or 64)
int encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, long long inner,
           long long outer, long long planes, long long ld, long long ps, int box_inner,
           int box_outer) {
  const EncodeFn fn = encoder();
  if (!fn) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2, static_cast<cuuint64_t>(ps) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        box_inner == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1 - static_cast<int>(r);
}

template <typename In, typename Out, int BN, int PLANES, int KD, bool B_MN>
int launch_core(const void* a, long long a_ld, long long a_ps, const void* b, long long b_ld,
                long long b_ps, void* c, long long m, long long n, long long k, void* stream) {
  using C = Cfg<BN, PLANES, KD>;
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const long long tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (m > 0x7fffffffLL || n > 0x7fffffffLL || k > 0x7fffffffLL || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType type = std::is_same<In, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_a{}, map_b{};  // k = 0: never read
  if (k > 0) {
    int rc = encode(&map_a, type, a, k, m, PLANES, a_ld, a_ps, KD, BM);
    if (rc == 0)
      rc = B_MN ? encode(&map_b, type, b, n, k, 1, b_ld, b_ps, 64, KD)
                : encode(&map_b, type, b, k, n, PLANES, b_ld, b_ps, KD, BN);
    if (rc != 0) return rc;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = gemm_kernel<In, Out, BN, PLANES, KD, B_MN>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, C::kSmem, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<Out*>(c), static_cast<int>(m), static_cast<int>(n),
      static_cast<int>((k + KD - 1) / KD));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int matmul_pack(int dtype, const void* src, void* dst, long long rows, long long k,
                           long long s_row, long long s_k, long long ld, long long ps,
                           void* stream) {
  switch (dtype) {
    case 0: return launch_pack<float, 3>(src, dst, rows, k, s_row, s_k, ld, ps, stream);
    case 1: return launch_pack<__nv_bfloat16, 1>(src, dst, rows, k, s_row, s_k, ld, ps, stream);
    case 2: return launch_pack<__half, 1>(src, dst, rows, k, s_row, s_k, ld, ps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int matmul_core(int dtype, const void* a, long long a_ld, long long a_ps, const void* b,
                           long long b_ld, long long b_ps, int b_mn, void* c, long long m,
                           long long n, long long k, void* stream) {
  if (dtype == 0 && !b_mn && k <= kF32DeepK)
    return launch_core<__nv_bfloat16, float, 128, 3, 64, false>(a, a_ld, a_ps, b, b_ld, b_ps, c, m,
                                                                n, k, stream);
  if (dtype == 0 && !b_mn)
    return launch_core<__nv_bfloat16, float, 128, 3, 32, false>(a, a_ld, a_ps, b, b_ld, b_ps, c, m,
                                                                n, k, stream);
  if (dtype == 1 && !b_mn)
    return launch_core<__nv_bfloat16, __nv_bfloat16, 256, 1, 64, false>(a, a_ld, a_ps, b, b_ld,
                                                                        b_ps, c, m, n, k, stream);
  if (dtype == 1)
    return launch_core<__nv_bfloat16, __nv_bfloat16, 256, 1, 64, true>(a, a_ld, a_ps, b, b_ld,
                                                                       b_ps, c, m, n, k, stream);
  if (dtype == 2 && !b_mn)
    return launch_core<__half, __half, 256, 1, 64, false>(a, a_ld, a_ps, b, b_ld, b_ps, c, m, n, k,
                                                          stream);
  if (dtype == 2)
    return launch_core<__half, __half, 256, 1, 64, true>(a, a_ld, a_ps, b, b_ld, b_ps, c, m, n, k,
                                                         stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int matmul_core_smem(int dtype, long long k) {
  return dtype != 0 ? CfgHalf::kSmem : k <= kF32DeepK ? CfgF32Deep::kSmem : CfgF32::kSmem;
}
