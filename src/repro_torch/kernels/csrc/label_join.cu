// Batched HL-index label join (Algorithm 5) for NVIDIA Hopper (sm_90a).
//
//   out[q] = max over j,k with ru[q,j] == rv[q,k] of min(su[q,j], sv[q,k]),
//   0 if the two rows share no hub.
//
// Replaces the TPU kernel `label_join_pallas` (body `_kernel`) of
// src/repro/kernels/label_join.py.  That kernel sweeps a [bq, bl, bl]
// all-pairs compare cube because a vector unit prefers it to a sequential
// merge; nothing of that shape is carried over.
//
// Operands: ru, su, rv, sv are [Q, L] int32, row-major and contiguous.
// Ranks ascend within a row and are padded with INT32_MAX; s-values are
// non-negative and padded with 0.  Padding therefore sorts last, and a
// pad-pad hit contributes min(0, 0) = 0: it is inert.  Any Q >= 1 and any
// L >= 1 are taken; the ragged edge is masked here, not padded by the
// caller.  Q == 0 or L == 0 never reaches a launch (the wrapper answers
// zeros), because a zero-size grid is a launch error.
//
// What bounds it: bytes.  The join reads 16*Q*L bytes and writes 4*Q, and
// does about log2(L) integer compares per label, far below the card's
// integer rate per byte moved.  At serving batch sizes (a few thousand
// rows, L of tens) the whole operand is a few MB and one launch is bounded
// by launch latency instead.
//
// Design: one warp per query row, WARPS_PER_BLOCK rows per block, so a
// row's 4*L-byte reads are coalesced and rows need no cross-warp traffic.
// The v row is staged in shared memory TILE entries at a time, so shared
// memory is fixed whatever L is (closure-derived snapshots have L = m).
// Each lane takes u entries lane, lane+32, ...; an entry whose s cannot
// beat the running max is skipped (that drops the s == 0 padding too, the
// pruning rule of Algorithm 5), as is one whose rank lies outside the
// staged tile; the others binary-search the tile and fold min(su, sv) into
// a register.  A warp max-reduce ends the row.  Integers only: the result
// equals the plain version's bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int TILE = 256;  // v-side entries staged per warp per sweep

__global__ void __launch_bounds__(WARPS_PER_BLOCK * WARP)
label_join_kernel(const int* __restrict__ ru, const int* __restrict__ su,
                  const int* __restrict__ rv, const int* __restrict__ sv,
                  int* __restrict__ out, long long q, int l) {
  __shared__ int tile_r[WARPS_PER_BLOCK][TILE];
  __shared__ int tile_s[WARPS_PER_BLOCK][TILE];

  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS_PER_BLOCK + warp;
  // A whole warp leaves together and only warp-level barriers follow, so
  // the ragged last block needs no block-wide participation.
  if (row >= q) return;

  const long long base = row * l;
  int* tr = tile_r[warp];
  int* ts = tile_s[warp];
  int best = 0;

  for (int t0 = 0; t0 < l; t0 += TILE) {
    const int tl = min(TILE, l - t0);
    for (int k = lane; k < tl; k += WARP) {
      tr[k] = rv[base + t0 + k];
      ts[k] = sv[base + t0 + k];
    }
    __syncwarp();
    const int first = tr[0];
    const int last = tr[tl - 1];
    for (int j = lane; j < l; j += WARP) {
      const int s = su[base + j];
      if (s <= best) continue;            // cannot improve (covers s == 0 padding)
      const int key = ru[base + j];
      if (key < first || key > last) continue;
      int lo = 0, hi = tl;                // lower bound of key in tr[0, tl)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tr[mid] < key) lo = mid + 1; else hi = mid;
      }
      // ranks are unique within a row, so this runs at most once for a
      // well-formed snapshot; the loop keeps the all-pairs answer if not
      for (; lo < tl && tr[lo] == key; ++lo) best = max(best, min(s, ts[lo]));
    }
    __syncwarp();                         // tile is overwritten next sweep
  }

  best = __reduce_max_sync(0xffffffffu, best);
  if (lane == 0) out[row] = best;
}

}  // namespace

// Enqueues the join on `stream` and returns cudaGetLastError() (0 = launched).
// No synchronisation and no allocation: `out` is [Q] int32 from the caller.
extern "C" int label_join_launch(const int* ru, const int* su, const int* rv,
                                 const int* sv, int* out, long long q, int l,
                                 void* stream) {
  if (q <= 0 || l <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (q + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  label_join_kernel<<<static_cast<unsigned int>(blocks), WARPS_PER_BLOCK * WARP, 0,
                      static_cast<cudaStream_t>(stream)>>>(ru, su, rv, sv, out, q, l);
  return static_cast<int>(cudaGetLastError());
}
