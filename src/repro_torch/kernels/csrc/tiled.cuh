// Register-blocked tile product shared by the three dense kernels
// (maxmin_matmul.cu, overlap.cu, threshold_step.cu), for sm_90a.
//
//   acc[i][j] = fold over k of step(acc[i][j], A[i, k], B[k, j])
//
// with the fold's zero and step given by an Op policy: (max, min) for the
// bottleneck semiring, (+, *) in float32 for the 0/1 products.
//
// One block of THREADS threads owns a BM x BN output tile; each thread owns
// a TM x TN block of it in registers.  The contraction is walked BK deep at
// a time: the block stages an A tile and a B tile in shared memory, k-major
// (tile[k][row]), so a thread reads its TM A values and TN B values for one
// k as two 16-byte loads each and does TM * TN steps on them.  Operands are
// converted to the accumulator type while staged (bf16 -> float32 for the
// overlap kernel).
//
// Edges: any M, N, K >= 1.  Entries past an operand's edge are staged as
// the fold's zero, which every Op here absorbs exactly: min(0, x) = 0 and
// max(acc, 0) = acc on the non-negative (max, min) domain, 0 * x = 0 under
// (+, *).  So the K tail needs no separate pass and no re-read, and stores
// are masked to the M x N edge.  K == 0 never reaches a launch: the wrappers
// answer zeros first, because a zero-size grid is a launch error.
//
// Simple first: one shared-memory buffer (two barriers per BK step), scalar
// global loads.  Double buffering with cp.async / TMA and tensor cores for
// the 0/1 products are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tiled {

constexpr int BM = 128;                          // output rows per block
constexpr int BN = 128;                          // output columns per block
constexpr int BK = 16;                           // contraction depth per stage
constexpr int TM = 8;                            // output rows per thread
constexpr int TN = 8;                            // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int PAD = 4;  // keeps each staged row 16-byte aligned, spreads banks
constexpr long long MAX_GRID_YZ = 65535;         // gridDim.y / gridDim.z limit

static_assert(BM == BN, "stage_rows serves both operands of overlap");
static_assert(TM == 8 && TN == 8, "load8 reads eight values per operand");
static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0, "staging");

// 16-byte aligned: load8 reads it with 16-byte vector loads.
template <typename Acc>
struct alignas(16) Smem {
  Acc a[BK][BM + PAD];
  Acc b[BK][BN + PAD];
};

// -- operand conversion ------------------------------------------------------

template <typename Acc, typename In>
__device__ __forceinline__ Acc load_as(const In* p) { return static_cast<Acc>(*p); }

template <>
__device__ __forceinline__ float load_as<float, __nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// -- fold policies -----------------------------------------------------------

__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }

// (max, min) semiring on non-negative values; 0 is its zero in both types.
template <typename T>
struct MaxMin {
  static __device__ __forceinline__ T zero() { return T(0); }
  static __device__ __forceinline__ T step(T acc, T a, T b) { return vmax(acc, vmin(a, b)); }
};

// Float32 multiply-add, rounded to nearest in full float32 (__fmaf_rn: the
// CUDA cores' FFMA; no TF32 anywhere).  Exact for 0/1 operands while a sum
// stays below 2^24.
struct MulAdd {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return __fmaf_rn(a, b, acc);
  }
};

// -- epilogues -----------------------------------------------------------------

struct Identity {
  template <typename T>
  __device__ __forceinline__ T operator()(T x) const { return x; }
};

// A path count > 0 becomes 1, else 0: counts never reach device memory.
struct Binarize {
  __device__ __forceinline__ float operator()(float x) const { return x > 0.0f ? 1.0f : 0.0f; }
};

// -- staging -------------------------------------------------------------------

// Rows [r0, r0 + BM) x columns [k0, k0 + BK) of a row-major [rows, kdim]
// operand into dst[k][r].  Sixteen neighbouring threads read sixteen
// neighbouring elements of one row.
template <typename In, typename Acc>
__device__ __forceinline__ void stage_rows(Acc (*dst)[BM + PAD], const In* __restrict__ src,
                                           long long rows, long long kdim, long long r0,
                                           long long k0) {
#pragma unroll
  for (int l = 0; l < BM * BK / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int r = idx / BK, c = idx % BK;
    const long long gr = r0 + r, gk = k0 + c;
    dst[c][r] = (gr < rows && gk < kdim) ? load_as<Acc>(src + gr * kdim + gk) : Acc(0);
  }
}

// Rows [k0, k0 + BK) x columns [c0, c0 + BN) of a row-major [kdim, cols]
// operand into dst[k][c].  A warp reads 32 neighbouring elements of a row.
template <typename In, typename Acc>
__device__ __forceinline__ void stage_cols(Acc (*dst)[BN + PAD], const In* __restrict__ src,
                                           long long cols, long long kdim, long long k0,
                                           long long c0) {
#pragma unroll
  for (int l = 0; l < BK * BN / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int r = idx / BN, c = idx % BN;
    const long long gk = k0 + r, gc = c0 + c;
    dst[r][c] = (gk < kdim && gc < cols) ? load_as<Acc>(src + gk * cols + gc) : Acc(0);
  }
}

template <typename T>
struct alignas(16) Vec4 {
  T v[4];
};

// Eight consecutive 4-byte values from shared memory as two 16-byte loads.
template <typename Acc>
__device__ __forceinline__ void load8(Acc (&out)[8], const Acc* p) {
  static_assert(sizeof(Acc) == 4, "4-byte accumulators only");
  const Vec4<Acc> x = *reinterpret_cast<const Vec4<Acc>*>(p);
  const Vec4<Acc> y = *reinterpret_cast<const Vec4<Acc>*>(p + 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = x.v[i];
    out[i + 4] = y.v[i];
  }
}

// -- the product -----------------------------------------------------------------

// This thread's TM x TN block of the output tile at (row0, col0) of the
// [M, N] product of A [M, K] (row-major) with B.  B_ROWS: B is given as a
// row-major [N, K] operand and its transpose is read (overlap's B * B^T;
// never materialised); otherwise B is row-major [K, N].
template <typename In, typename Acc, class Op, bool B_ROWS>
__device__ __forceinline__ void product(Acc (&acc)[TM][TN], Smem<Acc>& s,
                                        const In* __restrict__ a, const In* __restrict__ b,
                                        long long M, long long N, long long K, long long row0,
                                        long long col0) {
  const int ty = threadIdx.x / (BN / TN);
  const int tx = threadIdx.x % (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Op::zero();

  for (long long k0 = 0; k0 < K; k0 += BK) {
    stage_rows<In, Acc>(s.a, a, M, K, row0, k0);
    if constexpr (B_ROWS) {
      stage_rows<In, Acc>(s.b, b, N, K, col0, k0);
    } else {
      stage_cols<In, Acc>(s.b, b, N, K, k0, col0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      Acc av[TM], bv[TN];
      load8(av, &s.a[k][ty * TM]);
      load8(bv, &s.b[k][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = Op::step(acc[i][j], av[i], bv[j]);
    }
    __syncthreads();  // the tiles are overwritten by the next stage
  }
}

// Writes this thread's block through `epi`, masked to the [M, N] edge.
template <typename Out, typename Acc, class Epi>
__device__ __forceinline__ void store(Out* __restrict__ c, const Acc (&acc)[TM][TN],
                                      long long M, long long N, long long row0, long long col0,
                                      Epi epi) {
  const int ty = threadIdx.x / (BN / TN);
  const int tx = threadIdx.x % (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty * TM + i;
    if (r >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long col = col0 + tx * TN + j;
      if (col < N) c[r * N + col] = epi(acc[i][j]);
    }
  }
}

// Grid over an [M, N] output: x walks column tiles, y row tiles.
inline bool grid_for(long long M, long long N, dim3* grid) {
  const long long gx = (N + BN - 1) / BN, gy = (M + BM - 1) / BM;
  if (gx > 0x7fffffffLL || gy > MAX_GRID_YZ) return false;
  *grid = dim3(static_cast<unsigned int>(gx), static_cast<unsigned int>(gy), 1);
  return true;
}

}  // namespace tiled
