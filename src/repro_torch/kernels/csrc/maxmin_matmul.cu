// (max, min)-semiring matrix product for NVIDIA Hopper (sm_90a).
//
//   C[i, j] = max over k of min(A[i, k], B[k, j]),  A [M, K], B [K, N],
//   non-negative int32 or float32, C [M, N] of the same type.
//
// Replaces the TPU kernel `maxmin_matmul_pallas` (body `_kernel`) of
// src/repro/kernels/maxmin_matmul.py: the squaring step of the bottleneck
// closure W* that the closure backend runs ceil(log2 m) times.  The Pallas
// kernel sweeps a [bm, k_chunk, bn] broadcast on the vector unit and covers
// a k_chunk tail by letting dynamic_slice clamp and re-read; neither is
// carried over.  Here every tail (M, N and K) is masked by staging zeros,
// which the semiring absorbs exactly (see tiled.cuh).
//
// What bounds it: operations.  A (max, min) contraction has no tensor-core
// form, so each (i, j, k) costs one min and one max on the CUDA cores,
// 2 * M * N * K integer operations against 4 * (M K + K N + M N) bytes: at
// M = N = K = 12,704 that is 4.1e12 operations for 1.9 GB, some two
// thousand operations per byte.
//
// Design: the register-blocked tile product of tiled.cuh with the MaxMin
// policy.  A 256-thread block owns a 128 x 128 output tile, each thread an
// 8 x 8 block in registers; per staged k a thread loads 8 + 8 values from
// shared memory and does 64 min + 64 max on them, so shared-memory traffic
// stays far below the integer pipe's.  The accumulator starts at 0, the
// semiring zero in both types.  Integers (and float32 min/max, which do not
// round): the result equals the plain version bit for bit.
#include "tiled.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(tiled::THREADS, 2)
maxmin_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
                     long long m, long long n, long long k) {
  __shared__ tiled::Smem<T> s;
  const long long row0 = static_cast<long long>(blockIdx.y) * tiled::BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * tiled::BN;
  T acc[tiled::TM][tiled::TN];
  tiled::product<T, tiled::MaxMin<T>>(acc, s, a, b, m, n, k, row0, col0);
  tiled::store(c, acc, m, n, row0, col0);
}

template <typename T>
int launch(const T* a, const T* b, T* c, long long m, long long n, long long k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  if (!tiled::grid_for(m, n, &grid)) return static_cast<int>(cudaErrorInvalidConfiguration);
  maxmin_matmul_kernel<T><<<grid, tiled::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Enqueue C = A (max, min) B on `stream`; return cudaGetLastError() (0 =
// launched).  No synchronisation, no allocation: `c` is [M, N] from the
// caller; all three are row-major and contiguous.
extern "C" int maxmin_matmul_i32_launch(const int* a, const int* b, int* c, long long m,
                                        long long n, long long k, void* stream) {
  return launch<int>(a, b, c, m, n, k, stream);
}

extern "C" int maxmin_matmul_f32_launch(const float* a, const float* b, float* c, long long m,
                                        long long n, long long k, void* stream) {
  return launch<float>(a, b, c, m, n, k, stream);
}
