// Hyperedge-overlap (line-graph) matrix for NVIDIA Hopper (sm_90a).
//
//   W = B * B^T,  W[i, j] = |e_i ∩ e_j|,  W[i, i] = |e_i|,
//   B [m, n] 0/1 incidence, float32 or bfloat16; W [m, m] float32.
//
// Replaces the TPU kernel `overlap_pallas` (body `_kernel`) of
// src/repro/kernels/overlap.py.  As there, the second operand is B itself
// read with a transposed index, so B^T is never materialised.
//
// What bounds it: bytes, at the closure path's shape.  B [12,704, 242] is
// 12 MB, W is 645 MB written once, and the 2 * m^2 * n = 7.8e10 operations
// take a few tens of microseconds at the tensor cores' rate: writing W is
// the floor.  The 0/1 products are exact in any type that holds 0 and 1,
// and the float32 sums are exact integers while a count stays below 2^24.
//
// Design: the register-blocked tile product of tiled.cuh with the MulAdd
// policy (full float32 FFMA on the CUDA cores; no TF32 anywhere) and B read
// as rows for both operands.  bfloat16 input is converted to float32 while
// staged, so both types run the same float32 arithmetic and give the same W.
// Tensor cores (int8 or bf16 0/1 operands, exact) are later work.
#include "tiled.cuh"

namespace {

template <typename In>
__global__ void __launch_bounds__(tiled::THREADS, 2)
overlap_kernel(const In* __restrict__ b, float* __restrict__ w, long long m, long long n) {
  __shared__ tiled::Smem<float> s;
  const long long row0 = static_cast<long long>(blockIdx.y) * tiled::BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * tiled::BN;
  float acc[tiled::TM][tiled::TN];
  tiled::product<In, float, tiled::MulAdd, true>(acc, s, b, b, m, m, n, row0, col0);
  tiled::store(w, acc, m, m, row0, col0, tiled::Identity{});
}

template <typename In>
int launch(const In* b, float* w, long long m, long long n, void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  if (!tiled::grid_for(m, m, &grid)) return static_cast<int>(cudaErrorInvalidConfiguration);
  overlap_kernel<In><<<grid, tiled::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(b, w, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Enqueue W = B * B^T on `stream`; return cudaGetLastError() (0 = launched).
// No synchronisation, no allocation: `w` is [m, m] float32 from the caller.
extern "C" int overlap_f32_launch(const float* b, float* w, long long m, long long n,
                                  void* stream) {
  return launch<float>(b, w, m, n, stream);
}

extern "C" int overlap_bf16_launch(const void* b, float* w, long long m, long long n,
                                   void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(b), w, m, n, stream);
}
