// One boolean-closure squaring round over a threshold batch, for NVIDIA
// Hopper (sm_90a).
//
//   out[s] = (R[s] @ R[s] > 0),  R [S, m, m] 0/1 bf16, out the same.
//
// Replaces the TPU kernel `threshold_step_pallas` (body `_kernel`) of
// src/repro/kernels/threshold_closure.py: each of the ceil(log2 m) rounds of
// the threshold-batched closure (threshold_closure_mr).  As there, the
// binarisation is fused into the product's epilogue, so path counts never
// reach device memory.
//
// What bounds it: operations.  2 * S * m^3 = 2.05e13 at S = 5, m = 12,704,
// against 2 * S * m^2 bytes each way (1.6 GB in bf16); the least time is
// the tensor cores' at their int8 rate (the narrowest type that holds a
// 0/1 product exactly), 10.4 ms, and 20.7 ms at their bf16 rate.
//
// Design: the TMA-fed wgmma product of tc_gemm.cuh, one launch for the
// whole batch (the grid walks S x row-tile pairs x column tiles, two blocks
// per cluster sharing each B tile by TMA multicast).  Both operands are
// R[s] itself: A read by rows (K-major), B read as [K, N] rows (MN-major,
// the transposed wgmma descriptor), so no transpose is formed and nothing
// assumes R symmetric.  bf16 holds 0 and 1 exactly and the
// float32 path counts are exact integers below 2^24, so "> 0" is exact and
// the result equals the plain version bit for bit.  TMA needs m % 8 == 0
// (16-byte rows); the wrapper pads other m with zero rows and columns.
#include "tc_gemm.cuh"

// Enqueue out = (R @ R > 0) for every slice on `stream`; return a CUDA
// error code (0 = launched).  No synchronisation, no allocation: `r` is
// [S, m, m] bf16 with m % 8 == 0, 16-byte aligned; `out` is [S, m, m] bf16
// from the caller and must not alias `r`.
extern "C" int threshold_step_launch(const void* r, void* out, long long s, long long m,
                                     void* stream) {
  if (s <= 0 || m <= 0 || m % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a, b;
  if (!tc::encode(&a, r, m, m, s, tc::BK, tc::BM) ||        // R[s] rows: [m][k]
      !tc::encode(&b, r, m, m, s, tc::BOX_MN, tc::BK))       // R[s] as [k][n]
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::run<true, tc::Positive>(a, b, static_cast<__nv_bfloat16*>(out), m, m, m, s,
                                     static_cast<cudaStream_t>(stream));
}
