// One boolean-closure squaring round over a threshold batch, for NVIDIA
// Hopper (sm_90a).
//
//   out[s] = (R[s] @ R[s] > 0),  R [S, m, m] 0/1 float32, out the same.
//
// Replaces the TPU kernel `threshold_step_pallas` (body `_kernel`) of
// src/repro/kernels/threshold_closure.py: each of the ceil(log2 m) rounds of
// the threshold-batched closure (threshold_closure_mr).  As there, the
// binarisation is fused into the product's epilogue, so path counts never
// reach device memory.
//
// What bounds it: operations.  2 * S * m^3 = 2.05e13 at S = 5, m = 12,704,
// against 8 * S * m^2 = 6.5 GB read and written; the least time is the
// tensor cores' (int8 0/1 operands hold these products exactly).
//
// Design: the register-blocked tile product of tiled.cuh with the MulAdd
// policy, one launch for the whole batch (blockIdx.z walks the S slices),
// and the Binarize epilogue.  Full float32 FFMA on the CUDA cores, no TF32:
// a path count below 2^24 is an exact integer, so "> 0" is exact and the
// result equals the plain version bit for bit.  A tensor-core version is
// later work.
#include "tiled.cuh"

namespace {

__global__ void __launch_bounds__(tiled::THREADS, 2)
threshold_step_kernel(const float* __restrict__ r, float* __restrict__ out, long long m) {
  __shared__ tiled::Smem<float> s;
  const long long slice = static_cast<long long>(blockIdx.z) * m * m;
  const long long row0 = static_cast<long long>(blockIdx.y) * tiled::BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * tiled::BN;
  float acc[tiled::TM][tiled::TN];
  tiled::product<float, float, tiled::MulAdd, false>(acc, s, r + slice, r + slice, m, m, m,
                                                     row0, col0);
  tiled::store(out + slice, acc, m, m, row0, col0, tiled::Binarize{});
}

}  // namespace

// Enqueue out = (R @ R > 0) for every slice on `stream`; return
// cudaGetLastError() (0 = launched).  No synchronisation, no allocation:
// `out` is [S, m, m] float32 from the caller and must not alias `r`.
extern "C" int threshold_step_launch(const float* r, float* out, long long s, long long m,
                                     void* stream) {
  if (s <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  if (!tiled::grid_for(m, m, &grid) || s > tiled::MAX_GRID_YZ)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  grid.z = static_cast<unsigned int>(s);
  threshold_step_kernel<<<grid, tiled::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(r, out,
                                                                                       m);
  return static_cast<int>(cudaGetLastError());
}
