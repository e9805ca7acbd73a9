// Tensor-core product of 0/1 bf16 operands, shared by overlap.cu and
// threshold_step.cu, for sm_90a.
//
//   out[s][i, j] = epi( sum over k of A[s][i, k] * B[s][k, j] )
//
// A is row-major [M, K] (K-major).  B is given either as row-major [N, K]
// (K-major: overlap reads B's rows for both operands, so B^T is never
// formed) or as row-major [K, N] (MN-major: threshold_step's R @ R).  All
// operands are bf16; the sums are float32 in the tensor cores.  A product
// of 0/1 values is 0 or 1, exact in bf16, and a float32 sum of at most
// 2^24 such products is an exact integer, so the counts -- and "> 0" --
// equal the plain version bit for bit.
//
// Shape of the kernel (one block per 128 x 256 output tile, blocks in
// clusters of two):
//
// * a ring of STAGES shared-memory stages, each an A tile [128 x 64] and a
//   B tile [256 x 64] of bf16 (48 KB), filled by TMA
//   (cp.async.bulk.tensor, 128-byte swizzle) from one producer warp;
//   completion on one "full" mbarrier per stage, release on one "empty"
//   mbarrier per stage;
// * the two blocks of a cluster own row tiles 2p and 2p + 1 of one column
//   tile, so they need the same B tile: each producer loads its own A tile
//   and half of the B tile, multicast into both blocks.  That cuts the
//   operand traffic out of L2 by a third (32 KB a stage per block, not 48),
//   which is what held the one-block version back: on an H100 a threshold
//   round at [5, 12,704, 12,704] took 36.7 ms without it, 27.4 ms with it.  A
//   stage is refilled only once the consumers of both blocks have released
//   it: each consumer warp arrives on the empty barrier of both blocks;
// * two consumer warpgroups, each owning 64 rows x 256 columns of the tile
//   as 128 float32 accumulators per thread, issue
//   wgmma.mma_async.m64n256k16.f32.bf16.bf16 from the staged tiles, keep
//   two groups of them in flight (one was about 3 % slower on an H100 at
//   [5, 12,704, 12,704], tools/tc_variants.py), and release a stage once
//   the group that read it has completed;
// * an epilogue policy (Epi) maps each count to the output type: identity
//   to float32 for overlap, "> 0" to 0/1 for threshold_step.  Neighbouring
//   lanes swap halves with one shuffle so each thread writes four
//   consecutive values of one row: every 8-column group of a row is one
//   full 32-byte sector in float32.
//
// Edges: TMA fills every element past the operands' edges (rows, columns,
// the K tail) with zeros, which add nothing to a sum, and the stores are
// masked to [M, N].  TMA needs 16-byte global row strides, so the rows of
// every operand hold a multiple of 8 bf16 values; the wrappers pad once
// where they do not.  K == 0 never reaches a launch (a zero-size grid is a
// launch error): the wrappers answer first.
//
// Tile order: clusters are numbered along GROUP_PAIRS row-tile pairs
// before moving to the next column tile, so the blocks in flight share a
// few row and column panels in the 50 MB L2 (one [12,704 x 12,704] bf16
// slice is 323 MB).  On an H100 at [5, 12,704, 12,704], groups of 4 or 8
// pairs are level; 2 and 32 are slower (tools/tc_variants.py).  An odd count of row tiles gets one more, all past M:
// its A tile reads as zeros, its B half feeds its partner, its stores are
// masked off.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point (no link to libcuda),
// and passed to the kernel as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int BM = 128;                           // output rows per block
constexpr int BN = 256;                           // output columns per block
constexpr int BK = 64;                            // k per stage: one 128-byte bf16 row
constexpr int BOX_MN = 64;                        // MN-major B: columns per TMA box
constexpr int STAGES = 4;
constexpr int CLUSTER = 2;                        // blocks sharing one B tile
constexpr int GROUP_PAIRS = 8;                    // row-tile pairs per raster group
constexpr int MMA_IN_FLIGHT = 2;                  // wgmma groups a warpgroup keeps pending
constexpr int CONSUMER_THREADS = 256;             // two warpgroups
constexpr int THREADS = CONSUMER_THREADS + 32;    // + one producer warp
constexpr int CONSUMER_WARPS = CONSUMER_THREADS / 32;
constexpr int A_TILE_BYTES = BM * BK * 2;         // 16 KB
constexpr int B_TILE_BYTES = BN * BK * 2;         // 32 KB
constexpr int B_SHARE_ROWS = BN / CLUSTER;        // K-major B rows each block loads
constexpr int STAGE_BYTES = A_TILE_BYTES + B_TILE_BYTES;
constexpr int SWIZZLE_ATOM = 1024;                // 8 rows x 128 B
constexpr int SMEM_BYTES = SWIZZLE_ATOM + STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int ACC = BN / 2;                       // float32 accumulators per thread

static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may use");
static_assert(BN % BOX_MN == 0 && BN <= 256 && BM <= 256, "TMA box edges are at most 256");
static_assert((BN / BOX_MN) % CLUSTER == 0, "the MN-major B boxes split evenly");
static_assert(MMA_IN_FLIGHT < STAGES, "the producer needs a released stage to refill");

// -- shared-memory barriers and copies ---------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Arrives on the barrier at offset `bar` in block `rank` of the cluster.
// Default (.release.cta) semantics: the reads this arrival releases were
// made by wgmma and have completed (wgmma.wait_group) before it.  A
// .release.cluster arrival orders far more and, measured on an H100, made
// the product far slower than the version without clusters.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n\t}" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of both blocks of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed.  Every wait in
// this kernel is for work of its own block (a copy, or one k stage of the
// other side), so one that lasts WAIT_LIMIT_NS is a lost phase: the block
// traps, the launch fails with an error, and the card does not hang.
constexpr uint64_t WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// One box of a 3-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same box into the same offsets of every block of the cluster, each
// completing on its own barrier at offset `bar`.
__device__ __forceinline__ void tma_load_all(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int c0, int c1, int c2) {
  const uint16_t every_block = (1u << CLUSTER) - 1;
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(every_block), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// -- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.  Byte offsets: `lbo`
// (leading) and `sbo` (stride), both in 16-byte units in the descriptor.
//   K-major tile (rows of 128 B):  sbo = 1024 (next 8 rows), lbo unused (16).
//   MN-major tile (boxes of 64 columns x 64 k rows): sbo = 1024 (next 8 k
//   rows), lbo = 8192 (next 64-column box).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the accumulators in their registers across the asynchronous
// products (no copy the compiler might insert between issue and wait).
__device__ __forceinline__ void pin(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] * B[16 x 256], bf16 in, float32 sums.
// TRANS_B: B is MN-major in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[ACC], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]),
        "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),
        "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// -- epilogue policies -----------------------------------------------------------

// overlap: the counts themselves, float32.
struct Counts {
  using Out = float;
  static __device__ __forceinline__ float apply(float x) { return x; }
};

// threshold_step: a path count > 0 becomes 1, else 0, in bf16.
struct Positive {
  using Out = __nv_bfloat16;
  static __device__ __forceinline__ float apply(float x) { return x > 0.0f ? 1.0f : 0.0f; }
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Four consecutive values; p is aligned to four elements.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// -- the kernel --------------------------------------------------------------------

// One 128 x 256 tile of slice `s` per block.  map_a: A as [S][M][K] bf16,
// box {BK, BM}.  map_b: K-major [S][N][K], box {BK, B_SHARE_ROWS}; or
// MN-major [S][K][N], box {BOX_MN, BK}.  out: [S][M][N] row-major.
// pairs_m = ceil(row tiles / 2).
template <bool B_MN_MAJOR, class Epi>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
product_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, typename Epi::Out* __restrict__ out,
               int M, int N, int K, int pairs_m, int tiles_n) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA boxes and wgmma descriptors want 1024-byte atoms
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + SWIZZLE_ATOM - 1) & ~static_cast<uint32_t>(SWIZZLE_ATOM - 1);
  const uint32_t full = base + STAGES * STAGE_BYTES;  // STAGES barriers of 8 bytes
  const uint32_t empty = full + STAGES * 8;

  // tile of this block: the cluster's row pair and column tile (GROUP_PAIRS
  // pairs walked before the next column tile), then this block's row
  const int rank = static_cast<int>(cluster_rank());
  const int cluster_id = static_cast<int>(blockIdx.x) / CLUSTER;
  const int per_slice = pairs_m * tiles_n;
  const int slice = cluster_id / per_slice;
  const int t = cluster_id - slice * per_slice;
  const int group = GROUP_PAIRS * tiles_n;
  const int first_pair = (t / group) * GROUP_PAIRS;
  const int pairs_in_group = min(pairs_m - first_pair, GROUP_PAIRS);
  const int pair = first_pair + (t % group) % pairs_in_group;
  const int row0 = (pair * CLUSTER + rank) * BM;
  const int col0 = ((t % group) / pairs_in_group) * BN;
  const int k_tiles = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);  // the producer's expect_tx
      mbar_init(empty + 8 * i, CLUSTER * CONSUMER_WARPS);  // each consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // the partner's barriers exist before any copy or arrival reaches them

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == CONSUMER_WARPS) {  // producer warp: one thread issues every copy
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int stage = kt % STAGES;
        // a fresh barrier counts its previous (odd) phase as complete
        mbar_wait(empty + 8 * stage, ((kt / STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * stage;
        const uint32_t a_dst = base + stage * STAGE_BYTES;
        const uint32_t b_dst = a_dst + A_TILE_BYTES;
        // the whole stage lands here: A from this block, B half from each
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load(a_dst, &map_a, bar, kt * BK, row0, slice);
        if constexpr (B_MN_MAJOR) {
          constexpr int boxes = BN / BOX_MN / CLUSTER;
#pragma unroll
          for (int q = rank * boxes; q < (rank + 1) * boxes; ++q)
            tma_load_all(b_dst + q * BOX_MN * BK * 2, &map_b, bar, col0 + q * BOX_MN, kt * BK,
                         slice);
        } else {
          tma_load_all(b_dst + rank * B_SHARE_ROWS * BK * 2, &map_b, bar, kt * BK,
                       col0 + rank * B_SHARE_ROWS, slice);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // the partner's consumers may still arrive on our barriers
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt % STAGES;
    mbar_wait(full + 8 * stage, (kt / STAGES) & 1);
    const uint32_t a_tile = base + stage * STAGE_BYTES + wg * 64 * BK * 2;
    const uint32_t b_tile = base + stage * STAGE_BYTES + A_TILE_BYTES;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = smem_desc(a_tile + kk * 32, 16, 1024);
      if constexpr (B_MN_MAJOR) {
        const uint64_t db = smem_desc(b_tile + kk * 16 * BOX_MN * 2, BOX_MN * BK * 2, 1024);
        wgmma_m64n256k16<1>(acc, da, db);
      } else {
        const uint64_t db = smem_desc(b_tile + kk * 32, 16, 1024);
        wgmma_m64n256k16<0>(acc, da, db);
      }
    }
    wgmma_commit();
    pin(acc);
    // the group issued two stages earlier has read its tiles: release them
    // in both blocks (each producer writes its B half into both)
    wgmma_wait<MMA_IN_FLIGHT>();
    if (kt >= MMA_IN_FLIGHT && lane == 0)
      for (uint32_t r = 0; r < CLUSTER; ++r)
        mbar_arrive_cluster(empty + 8 * ((kt - MMA_IN_FLIGHT) % STAGES), r);
  }
  wgmma_wait<0>();
  pin(acc);

  // epilogue.  Accumulator 4j + 2i + b holds row (16 w + lane / 4 + 8 i),
  // column (8 j + 2 (lane % 4) + b) of this warpgroup's 64 x 256 block.
  using Out = typename Epi::Out;
  Out* __restrict__ dst = out + static_cast<long long>(slice) * M * N;
  const int quad = lane % 4;
  const int row = row0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  if ((N & 3) == 0) {
    // lanes 2c and 2c + 1 swap halves: the even lane then holds row r,
    // columns 8 j + 4 c .. + 3; the odd lane row r + 8, the same columns
    const bool odd = quad & 1;
    const int r = row + (odd ? 8 : 0);
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j) {
      const float v0 = Epi::apply(acc[4 * j]), v1 = Epi::apply(acc[4 * j + 1]);
      const float v2 = Epi::apply(acc[4 * j + 2]), v3 = Epi::apply(acc[4 * j + 3]);
      const float g0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
      const int c = col0 + 8 * j + 4 * (quad / 2);
      if (r < M && c < N) {
        Out* p = dst + static_cast<long long>(r) * N + c;
        if (odd) store4(p, g0, g1, v2, v3);
        else store4(p, v0, v1, g0, g1);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int r = row + 8 * i, c = col0 + 8 * j + 2 * quad + b;
          if (r < M && c < N)
            store1(dst + static_cast<long long>(r) * N + c, Epi::apply(acc[4 * j + 2 * i + b]));
        }
  }
  __syncwarp();
  cluster_sync();  // our arrivals on the partner's barriers are done before either exits
}

// -- host side -----------------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, through the runtime (so the
// library needs no link to libcuda); nullptr if the driver lacks it.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A [slices][rows][inner] row-major bf16 tensor at `base`, read in boxes of
// box_rows x box_inner with the 128-byte swizzle; elements past any edge
// read as zero.  inner must be a multiple of 8 (16-byte row stride) and
// `base` 16-byte aligned.
inline bool encode(CUtensorMap* map, const void* base, long long inner, long long rows,
                   long long slices, int box_inner, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr || inner % 8 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slices)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * rows * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Enqueues the product over S slices on `stream`; returns a CUDA error code
// (0 = launched).
template <bool B_MN_MAJOR, class Epi>
inline int run(const CUtensorMap& map_a, const CUtensorMap& map_b, typename Epi::Out* out,
               long long M, long long N, long long K, long long S, cudaStream_t stream) {
  const long long pairs_m = (M + CLUSTER * BM - 1) / (CLUSTER * BM);
  const long long tiles_n = (N + BN - 1) / BN;
  const long long blocks = S * pairs_m * CLUSTER * tiles_n;
  if (M <= 0 || N <= 0 || K <= 0 || S <= 0 || M > 0x7fffffff || N > 0x7fffffff ||
      K > 0x7fffffff || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = product_kernel<B_MN_MAJOR, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(blocks), THREADS, SMEM_BYTES, stream>>>(
      map_a, map_b, out, static_cast<int>(M), static_cast<int>(N), static_cast<int>(K),
      static_cast<int>(pairs_m), static_cast<int>(tiles_n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
