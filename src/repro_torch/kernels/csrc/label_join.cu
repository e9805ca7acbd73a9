// Batched HL-index label join (Algorithm 5) for NVIDIA Hopper (sm_90a).
//
//   out[q] = max over j,k with ru[q,j] == rv[q,k] of min(su[q,j], sv[q,k]),
//   0 if the two rows share no hub.
//
// Replaces the TPU kernel `label_join_pallas` (body `_kernel`) of
// src/repro/kernels/label_join.py, and the row gather that feeds it in the
// reference's `KernelSnapshot.mr`.  That kernel sweeps a [bq, bl, bl]
// all-pairs compare cube because a vector unit prefers it to a sequential
// merge; nothing of that shape is carried over.
//
// Two entry points, one join.  `label_join_launch` takes four [Q, L]
// operands, row q of each.  `label_join_gather_launch` takes the
// snapshot's own [n, L] `ranks` / `svals` and two [Q] int64 id vectors and
// reads row us[q] (u side) and row vs[q] (v side) itself, so the gathered
// rows never touch device memory.  Both instantiate the same templated
// bodies below; only the row addressing (`DirectRows`, `GatheredRows`)
// differs.  An id outside [0, n) stops the kernel (`__trap`), as an
// out-of-range index does in PyTorch's own gather on the card.
//
// Operands: ranks ascend within a row and are padded with INT32_MAX;
// s-values are non-negative and padded with 0.  Padding therefore sorts
// last, and a pad-pad hit contributes min(0, 0) = 0: it is inert.  Any
// Q >= 1 and L >= 1 are taken; the ragged edge is masked here.  Q == 0 or
// L == 0 never reaches a launch (the wrapper answers zeros), because a
// zero-size grid is a launch error.
//
// What bounds it: bytes.  The join does about log2(L) integer compares per
// label, far below the card's integer rate per byte moved.  On the serving
// path (L = 15 on an 89k-vertex graph, 2^20 pairs) the rows come from a
// snapshot of about 11 MB, which stays in the 50 MB L2; unfused, the
// gather would write and the join read back 16*Q*L bytes of rows.  By id,
// each snapshot row is read about 24 times (2^20 pairs over 89,000 rows),
// from L2, in 60-byte pieces that straddle 32-byte sectors: L2 traffic and
// read latency set the pace there, far above the bound that counts each
// row once.
//
// Design, by row length (chosen once per launch on the host from L, never
// per row; `label_join_lanes_per_query` says which):
//
// * Short rows, L <= 32: a group of G lanes per query, G the smallest
//   power of two >= L, so 32 / G queries share a warp (two at L = 15) and
//   at most half a group idles.  Lane j holds u entry j and v entry j in
//   registers; no shared memory, no staging.  A group answers
//   QUERIES_PER_GROUP queries and issues all their loads (ids, then rows)
//   before it joins any: the rows are short and scattered, so the kernel
//   is bound by how many reads it keeps in flight, not by their bytes.
//   Two queries per group in blocks of 128 threads, one pass per block,
//   measured fastest (tools/label_join_variants.py): more queries per
//   group, or a grid-stride loop, cost registers and so occupancy.
//   Each lane finds its u rank in the group's v row by a lower-bound
//   search over lanes (`__shfl_sync` with width G, each lane naming its
//   own source lane: log2(G) probes), then fetches the rank and s at that
//   lane, and the group folds min(s_u, s_v) into a max by a butterfly over
//   its G lanes.
//   Duplicate ranks in a malformed v row: a lower bound hits the first
//   entry of a run of equal ranks, which gives the all-pairs answer when
//   that entry's s is the run's largest (min(s_u, .) is monotone).  Each
//   lane compares its v entry with the next one; if any run in the warp
//   has an s that rises, the warp (a uniform branch) takes an all-pairs
//   sweep over its group's lanes instead.  Well-formed rows never do.
// * Long rows, L > 32: one warp per query row, WARPS_PER_BLOCK rows per
//   block.  The v row is staged in shared memory TILE entries at a time,
//   so shared memory is fixed whatever L is (closure-derived snapshots
//   have L = m).  Each lane takes u entries lane, lane+32, ...; an entry
//   whose s cannot beat the running max is skipped (that drops the s == 0
//   padding too, the pruning rule of Algorithm 5), as is one whose rank
//   lies outside the staged tile; the others binary-search the tile and
//   fold min(su, sv) into a register, walking any run of equal ranks.  A
//   warp max-reduce ends the row.
//
// Integers only: the result equals the plain version's bit for bit.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PAD = INT_MAX;
constexpr int SHORT_BLOCK = 128;     // threads per block, short-row route
constexpr int QUERIES_PER_GROUP = 2; // queries each lane group answers
constexpr int WARPS_PER_BLOCK = 8;   // query rows per block, long-row route
constexpr int TILE = 256;            // v-side entries staged per warp per sweep

// Lanes per query for rows of length l: the smallest power of two >= l for
// l <= 32, 0 for the warp-per-row route, -1 for an empty row.
__host__ __device__ constexpr int lanes_per_query(int l) {
  if (l <= 0) return -1;
  if (l > WARP) return 0;
  int g = 1;
  while (g < l) g <<= 1;
  return g;
}

// Row q of each operand.
struct DirectRows {
  __device__ long long u(long long q) const { return q; }
  __device__ long long v(long long q) const { return q; }
};

// Row us[q] / vs[q] of a [n, L] snapshot.
struct GatheredRows {
  const long long* us;
  const long long* vs;
  long long n;
  __device__ long long checked(long long id) const {
    if (id < 0 || id >= n) __trap();
    return id;
  }
  __device__ long long u(long long q) const { return checked(us[q]); }
  __device__ long long v(long long q) const { return checked(vs[q]); }
};

// The join of one query by its group of G lanes: lane j holds u entry j
// (key, s_u) and v entry j (r_v, s_v).  Every lane of the warp calls it.
template <int G>
__device__ __forceinline__ int group_join(int key, int s_u, int r_v, int s_v) {
  // lower bound of key in the group's v row, clamped to G - 1: afterwards
  // v[pos] == key iff key is in the row, and v[pos] is its first copy
  int pos = 0;
#pragma unroll
  for (int step = G / 2; step >= 1; step >>= 1) {
    const int probe = __shfl_sync(FULL, r_v, pos + step - 1, G);
    if (probe < key) pos += step;
  }
  const int r_at = __shfl_sync(FULL, r_v, pos, G);
  const int s_at = __shfl_sync(FULL, s_v, pos, G);
  int best = r_at == key ? min(s_u, s_at) : 0;

  // a run of equal v ranks whose s rises: the first copy is not the run's
  // largest, so this warp joins all pairs (the group's last lane reads
  // itself back and never flags)
  const int r_next = __shfl_down_sync(FULL, r_v, 1, G);
  const int s_next = __shfl_down_sync(FULL, s_v, 1, G);
  if (__any_sync(FULL, r_next == r_v && s_next > s_v)) {
    best = 0;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int r = __shfl_sync(FULL, r_v, k, G);
      const int s = __shfl_sync(FULL, s_v, k, G);
      if (r == key) best = max(best, min(s_u, s));
    }
  }

#pragma unroll
  for (int off = G / 2; off >= 1; off >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, off, G));
  return best;
}

// Short rows: a block holds SHORT_BLOCK / G lane groups and answers
// K = QUERIES_PER_GROUP times as many consecutive queries; part k of group
// g takes query first + k * SHORT_BLOCK / G + g, so each load instruction
// of a warp reads neighbouring queries.  All K queries' loads are issued
// before any join, to keep that many row reads in flight per lane.
template <int G, class Rows>
__global__ void __launch_bounds__(SHORT_BLOCK)
join_short(const int* __restrict__ ru, const int* __restrict__ su,
           const int* __restrict__ rv, const int* __restrict__ sv,
           int* __restrict__ out, long long q, int l, Rows rows) {
  constexpr int GROUPS = SHORT_BLOCK / G;
  constexpr int K = QUERIES_PER_GROUP;
  const long long first = static_cast<long long>(blockIdx.x) * GROUPS * K;
  const int group = threadIdx.x / G;
  const int j = threadIdx.x % G;
  // every lane of a live warp takes part in the shuffles, so only a whole
  // warp past the last query leaves early
  if (first + (threadIdx.x & ~(WARP - 1)) / G >= q) return;

  long long query[K];
  bool load[K];
  long long bu[K], bv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    query[k] = first + k * GROUPS + group;
    load[k] = query[k] < q && j < l;
    if (load[k]) {
      bu[k] = rows.u(query[k]) * l;
      bv[k] = rows.v(query[k]) * l;
    }
  }
  int key[K], s_u[K], r_v[K], s_v[K];   // lanes past L hold padding
#pragma unroll
  for (int k = 0; k < K; ++k) {
    key[k] = load[k] ? ru[bu[k] + j] : PAD;
    s_u[k] = load[k] ? su[bu[k] + j] : 0;
    r_v[k] = load[k] ? rv[bv[k] + j] : PAD;
    s_v[k] = load[k] ? sv[bv[k] + j] : 0;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int best = group_join<G>(key[k], s_u[k], r_v[k], s_v[k]);
    if (j == 0 && query[k] < q) out[query[k]] = best;
  }
}

template <class Rows>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * WARP)
join_long(const int* __restrict__ ru, const int* __restrict__ su,
          const int* __restrict__ rv, const int* __restrict__ sv,
          int* __restrict__ out, long long q, int l, Rows rows) {
  __shared__ int tile_r[WARPS_PER_BLOCK][TILE];
  __shared__ int tile_s[WARPS_PER_BLOCK][TILE];

  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS_PER_BLOCK + warp;
  // A whole warp leaves together and only warp-level barriers follow, so
  // the ragged last block needs no block-wide participation.
  if (row >= q) return;

  const long long bu = rows.u(row) * l;
  const long long bv = rows.v(row) * l;
  int* tr = tile_r[warp];
  int* ts = tile_s[warp];
  int best = 0;

  for (int t0 = 0; t0 < l; t0 += TILE) {
    const int tl = min(TILE, l - t0);
    for (int k = lane; k < tl; k += WARP) {
      tr[k] = rv[bv + t0 + k];
      ts[k] = sv[bv + t0 + k];
    }
    __syncwarp();
    const int first = tr[0];
    const int last = tr[tl - 1];
    for (int j = lane; j < l; j += WARP) {
      const int s = su[bu + j];
      if (s <= best) continue;            // cannot improve (covers s == 0 padding)
      const int key = ru[bu + j];
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

  best = __reduce_max_sync(FULL, best);
  if (lane == 0) out[row] = best;
}

template <int G, class Rows>
cudaError_t launch_short(const int* ru, const int* su, const int* rv,
                         const int* sv, int* out, long long q, int l,
                         Rows rows, cudaStream_t stream) {
  constexpr long long per_block = SHORT_BLOCK / G * QUERIES_PER_GROUP;
  const long long blocks = (q + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  join_short<G, Rows><<<static_cast<unsigned int>(blocks), SHORT_BLOCK, 0,
                        stream>>>(ru, su, rv, sv, out, q, l, rows);
  return cudaGetLastError();
}

template <class Rows>
cudaError_t launch_join(const int* ru, const int* su, const int* rv,
                        const int* sv, int* out, long long q, int l,
                        Rows rows, void* stream_ptr) {
  if (q <= 0 || l <= 0) return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  switch (lanes_per_query(l)) {
    case 1: return launch_short<1>(ru, su, rv, sv, out, q, l, rows, stream);
    case 2: return launch_short<2>(ru, su, rv, sv, out, q, l, rows, stream);
    case 4: return launch_short<4>(ru, su, rv, sv, out, q, l, rows, stream);
    case 8: return launch_short<8>(ru, su, rv, sv, out, q, l, rows, stream);
    case 16: return launch_short<16>(ru, su, rv, sv, out, q, l, rows, stream);
    case 32: return launch_short<32>(ru, su, rv, sv, out, q, l, rows, stream);
    default: break;
  }
  const long long blocks = (q + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  join_long<Rows><<<static_cast<unsigned int>(blocks), WARPS_PER_BLOCK * WARP,
                    0, stream>>>(ru, su, rv, sv, out, q, l, rows);
  return cudaGetLastError();
}

}  // namespace

// Each entry point enqueues the join on `stream` and returns
// cudaGetLastError() (0 = launched).  No synchronisation and no
// allocation: `out` is [Q] int32 from the caller.

// ru, su, rv, sv: [Q, L] int32, row-major and contiguous.
extern "C" int label_join_launch(const int* ru, const int* su, const int* rv,
                                 const int* sv, int* out, long long q, int l,
                                 void* stream) {
  return static_cast<int>(
      launch_join(ru, su, rv, sv, out, q, l, DirectRows{}, stream));
}

// ranks, svals: [n, L] int32, row-major and contiguous (the snapshot);
// us, vs: [Q] int64 row ids in [0, n).
extern "C" int label_join_gather_launch(const int* ranks, const int* svals,
                                        const long long* us,
                                        const long long* vs, int* out,
                                        long long q, int l, long long n,
                                        void* stream) {
  return static_cast<int>(launch_join(ranks, svals, ranks, svals, out, q, l,
                                       GatheredRows{us, vs, n}, stream));
}

// The route both entry points take for rows of length l: lanes per query
// (1, 2, 4, 8, 16 or 32), 0 for one warp per row, -1 for l <= 0.
extern "C" int label_join_lanes_per_query(int l) { return lanes_per_query(l); }
