// Hyperedge-overlap (line-graph) matrix for NVIDIA Hopper (sm_90a).
//
//   W = B * B^T,  W[i, j] = |e_i ∩ e_j|,  W[i, i] = |e_i|,
//   B [m, n] 0/1 incidence in bf16; W [m, m] float32.
//
// Replaces the TPU kernel `overlap_pallas` (body `_kernel`) of
// src/repro/kernels/overlap.py.  As there, the second operand is B itself
// read by rows, so B^T is never materialised.
//
// What bounds it: bytes, at the closure path's shape.  B [12,704, 242] is
// 6 MB in bf16, W is 645 MB written once, and the 2 * m^2 * n = 7.8e10
// operations take some 40 microseconds at the tensor cores' int8 rate:
// writing W is the floor (0.19 ms).
//
// Design: the TMA-fed wgmma product of tc_gemm.cuh with both operands
// K-major (rows of B); K = n is covered in 64-deep stages whose tail TMA
// fills with zeros.  B is 6 MB and stays in L2, so the operands cost L2
// reads only; the clusters' multicast halves the second operand's.  The epilogue writes each count as float32 with 16-byte
// stores, four consecutive columns per thread, so every 8-column group of a
// row is one whole 32-byte sector.  The 0/1 products are exact in bf16 and
// the float32 sums are exact integers below 2^24.  TMA needs n % 8 == 0
// (16-byte rows); the wrapper pads other n with zero columns, which add
// nothing to B * B^T.
//
// The rectangular entry overlap_rows_bf16_launch computes W = A * B^T for
// two 0/1 operands A [ma, n] and B [mb, n]: the rows of W that one rank of
// a process mesh owns (A its row block of the incidence, B the whole).  It
// replaces no TPU kernel: the reference computes that product as a
// sharded `x @ x.T` in XLA (src/repro/core/hypergraph.py:285-301); the
// port runs it through the same tensor-core product as `overlap`, with A
// and B encoded as two tensor maps instead of one.  Bound as above: the
// [ma, mb] float32 rows written once.
#include "tc_gemm.cuh"

// Enqueue W = B * B^T on `stream`; return a CUDA error code (0 =
// launched).  No synchronisation, no allocation: `b` is [m, n] bf16 with
// n % 8 == 0, 16-byte aligned; `w` is [m, m] float32 from the caller.
extern "C" int overlap_bf16_launch(const void* b, float* w, long long m, long long n,
                                   void* stream) {
  if (m <= 0 || n <= 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap rows_a, rows_b;
  if (!tc::encode(&rows_a, b, n, m, 1, tc::BK, tc::BM) ||
      !tc::encode(&rows_b, b, n, m, 1, tc::BK, tc::B_SHARE_ROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::run<false, tc::Counts>(rows_a, rows_b, w, m, m, n, 1,
                                    static_cast<cudaStream_t>(stream));
}

// Enqueue W = A * B^T on `stream`; return a CUDA error code (0 =
// launched).  `a` is [ma, n] and `b` is [mb, n], both bf16 with n % 8 == 0
// and 16-byte aligned; `w` is [ma, mb] float32 from the caller.
extern "C" int overlap_rows_bf16_launch(const void* a, const void* b, float* w, long long ma,
                                        long long mb, long long n, void* stream) {
  if (ma <= 0 || mb <= 0 || n <= 0 || n % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap rows_a, rows_b;
  if (!tc::encode(&rows_a, a, n, ma, 1, tc::BK, tc::BM) ||
      !tc::encode(&rows_b, b, n, mb, 1, tc::BK, tc::B_SHARE_ROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::run<false, tc::Counts>(rows_a, rows_b, w, ma, mb, n, 1,
                                    static_cast<cudaStream_t>(stream));
}
