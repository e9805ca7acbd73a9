// Register-blocked tile product on the CUDA cores, for sm_90a: the body of
// maxmin_matmul.cu.
//
//   acc[i][j] = fold over k of step(acc[i][j], A[i, k], B[k, j])
//
// with the fold's zero and step given by an Op policy: (max, min) for the
// bottleneck semiring, which has no tensor-core form.  (The 0/1 products
// of overlap.cu and threshold_step.cu run on the tensor cores instead:
// tc_gemm.cuh.)
//
// One block of THREADS threads owns a BM x BN output tile; each thread owns
// a TM x TN block of it in registers.  The contraction is walked BK deep at
// a time: the block stages an A tile and a B tile in shared memory, k-major
// (tile[k][row]), so a thread reads its TM A values and TN B values for one
// k as two 16-byte loads each and does TM * TN steps on them.
//
// Edges: any M, N, K >= 1.  Entries past an operand's edge are staged as
// the fold's zero, which (max, min) absorbs exactly on its non-negative
// domain: min(0, x) = 0 and max(acc, 0) = acc.  So the K tail needs no
// separate pass and no re-read, and stores are masked to the M x N edge.
// K == 0 never reaches a launch: the wrapper answers zeros first, because a
// zero-size grid is a launch error.
//
// Simple first: one shared-memory buffer (two barriers per BK step), scalar
// global loads.  Double buffering and the register spills that
// __launch_bounds__(THREADS, 2) causes are later work.
#pragma once

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

static_assert(TM == 8 && TN == 8, "load8 reads eight values per operand");
static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0, "staging");

// 16-byte aligned: load8 reads it with 16-byte vector loads.
template <typename T>
struct alignas(16) Smem {
  T a[BK][BM + PAD];
  T b[BK][BN + PAD];
};

// -- fold policy -------------------------------------------------------------

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

// -- staging -------------------------------------------------------------------

// Rows [r0, r0 + BM) x columns [k0, k0 + BK) of a row-major [rows, kdim]
// operand into dst[k][r].  Sixteen neighbouring threads read sixteen
// neighbouring elements of one row.
template <typename T>
__device__ __forceinline__ void stage_rows(T (*dst)[BM + PAD], const T* __restrict__ src,
                                           long long rows, long long kdim, long long r0,
                                           long long k0) {
#pragma unroll
  for (int l = 0; l < BM * BK / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int r = idx / BK, c = idx % BK;
    const long long gr = r0 + r, gk = k0 + c;
    dst[c][r] = (gr < rows && gk < kdim) ? src[gr * kdim + gk] : T(0);
  }
}

// Rows [k0, k0 + BK) x columns [c0, c0 + BN) of a row-major [kdim, cols]
// operand into dst[k][c].  A warp reads 32 neighbouring elements of a row.
template <typename T>
__device__ __forceinline__ void stage_cols(T (*dst)[BN + PAD], const T* __restrict__ src,
                                           long long cols, long long kdim, long long k0,
                                           long long c0) {
#pragma unroll
  for (int l = 0; l < BK * BN / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int r = idx / BN, c = idx % BN;
    const long long gk = k0 + r, gc = c0 + c;
    dst[r][c] = (gk < kdim && gc < cols) ? src[gk * cols + gc] : T(0);
  }
}

template <typename T>
struct alignas(16) Vec4 {
  T v[4];
};

// Eight consecutive 4-byte values from shared memory as two 16-byte loads.
template <typename T>
__device__ __forceinline__ void load8(T (&out)[8], const T* p) {
  static_assert(sizeof(T) == 4, "4-byte values only");
  const Vec4<T> x = *reinterpret_cast<const Vec4<T>*>(p);
  const Vec4<T> y = *reinterpret_cast<const Vec4<T>*>(p + 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = x.v[i];
    out[i + 4] = y.v[i];
  }
}

// -- the product -----------------------------------------------------------------

// This thread's TM x TN block of the output tile at (row0, col0) of the
// [M, N] product of A [M, K] with B [K, N], both row-major.
template <typename T, class Op>
__device__ __forceinline__ void product(T (&acc)[TM][TN], Smem<T>& s, const T* __restrict__ a,
                                        const T* __restrict__ b, long long M, long long N,
                                        long long K, long long row0, long long col0) {
  const int ty = threadIdx.x / (BN / TN);
  const int tx = threadIdx.x % (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Op::zero();

  for (long long k0 = 0; k0 < K; k0 += BK) {
    stage_rows(s.a, a, M, K, row0, k0);
    stage_cols(s.b, b, N, K, k0, col0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T av[TM], bv[TN];
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

// Writes this thread's block, masked to the [M, N] edge.
template <typename T>
__device__ __forceinline__ void store(T* __restrict__ c, const T (&acc)[TM][TN], long long M,
                                      long long N, long long row0, long long col0) {
  const int ty = threadIdx.x / (BN / TN);
  const int tx = threadIdx.x % (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty * TM + i;
    if (r >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long col = col0 + tx * TN + j;
      if (col < N) c[r * N + col] = acc[i][j];
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
