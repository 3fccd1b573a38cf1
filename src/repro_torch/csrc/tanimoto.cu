// tanimoto: batched Tanimoto top-k over packed fingerprints, for sm_90a.
//
// Replaces the Pallas kernel `tanimoto_blocks_pallas` (body
// `_tanimoto_kernel`) of src/repro/kernels/tanimoto/kernel.py, wrapped there
// by `tanimoto_topk_pallas`.  (Q, W) uint32 queries against an (N, W)
// uint32 plane with (N,) int32 row popcounts in; (Q, k) float32 scores and
// (Q, k) int32 rows out, bit-exact with the reference `tanimoto_topk_ref`:
//
//   c = sum_w popc(q[w] & d[w]),  u = |q| + |d| - c,
//   score = u > 0 ? float(c) / float(u) (IEEE round to nearest) : 0,
//   order (score desc, row asc), pads (-1.0, -1) when fewer than k rows.
//
// Bound on an H100: operations.  Every query meets every row, so the work is
// Q * N * W population counts, and the card retires 16 of those per clock
// per SM against 64 ANDs or adds.  The plane's N * (4W + 4) bytes are read
// once per group of up to 8 queries: at W = 32 a group's popcounts take
// longer than its read (8 * 32 popcounts per 132 bytes).  The top-k must
// cost little beside the scan, for every k.
//
// Keys.  A candidate is one 64-bit key, (float bits of score) << 32 |
// (0x7FFFFFFF - row).  Scores are >= 0, so their IEEE bits order as
// unsigned integers: a larger key is a better candidate, an equal score
// goes to the lower row, and every comparison is one 64-bit compare.  Real
// keys are >= 1 (rows < 2^31 - 1); 0 is an empty slot, written as a pad.
//
// Route "filter" (k < N and k <= 8,192): two launches.
//
//   Stage 1 (tani_filter): a block of 8 warps owns QPB queries and one
//   slice of rows.  Each warp scores a 32-row batch against all QPB
//   queries (lane l owns row base + l; the row's words are loaded once, the
//   query words are broadcast from shared memory), so the plane is read
//   once per query group.  Per query the block keeps, in shared memory, a
//   threshold tau, the best P >= k keys seen (sorted), and a buffer of
//   fresh keys (512, or up to 4,096 for P >= 512 where shared memory
//   allows: fewer folds).  A key enters the buffer only if it beats tau: a
//   ballot and one shared atomic per warp append it, nothing is ordered and
//   nothing shifts.  After every round (one batch per warp) the block
//   votes; once a buffer holds more than min(its size - 256, 2P) keys, a
//   team of 8 / QPB warps per query folds it (team_fold: bitonic runs of P
//   keys, a tree that keeps the best run, a half-cleaner against the kept
//   list and a bitonic merge) and
//   raises tau to the k-th kept key.  Each slice's tau is also a lower bound
//   on the query's k-th best key over the whole plane, so the block
//   publishes it (atomicMax on a per-query word in device memory) and takes
//   back the largest any slice has published, at every fold and every 16
//   rounds: blocks scheduled later start with a high threshold and append
//   almost nothing.  At the end the block writes its k best keys, sorted,
//   as one run.  A W = 32 row is read with all eight 16-byte loads in
//   flight at once.
//
//   Stage 2 (tani_merge_runs): a block per query folds its slices' runs,
//   `slots` at a time, into one sorted list by a tree of the same
//   half-cleaner and bitonic merges in shared memory, and writes the first
//   k, with pads.
//
// Route "sort" (k >= N, or k > 8,192): every key of a chunk of queries is
// written to scratch (tani_keys), each query's keys are sorted by a bitonic
// sort in device memory (strides below 8,192 inside a block's shared memory,
// the rest one launch per stride), and the first k are written with pads
// (tani_write).  At k > N over a small plane this is one block-local sort.
//
// What bounds it now (measured on an H100 80GB HBM3 at 700 W): at k = 32
// the scan, 0.81 of the popcount bound; at k >= 512 two blocks an SM
// (their kept lists fill shared memory) and the first wave's folds, before
// any slice has a threshold to share.
//
// What was dropped.  The first design: a sorted top-k per (query, warp)
// with one shifting insertion per candidate (O(k / 32) dependent warp steps
// each), slices sized only to fill the card (so k = 1,024 at 4,194,304 rows
// had 132 slices, each filled with k inserts), a serial k-round warp merge,
// and, for a k whose lists overflowed shared memory, the same insertion into
// device memory.  Measured against this design and not kept
// (scripts/tanimoto_variants.py, H100 80GB HBM3 at 700 W): a loop of
// dependent row loads (158.5 against 131.6 ms over the PubChem plane at
// k = 1,024; 16.9 against 14.5 ms over 4,194,304 rows), one warp per query
// for every fold at 4 queries a block (18.9 against 18.1 ms at k = 2,048;
// 0.397 against 0.324 ms for a request of 4 queries at k = 1,024), and
// buffers of 512 keys at every k (19.0 against 18.1 ms at k = 2,048).
// Reading the shared thresholds back only every 16 rounds measured the
// same as at every fold.  Not kept either: one fold over all queries by
// the whole block, a barrier a stage, and loading four pairs before
// storing in each stage (more registers).
//
// Every comparison is on the key, a total order, so the result does not
// depend on the slicing, the lane order, the merge order or the order in
// which blocks publish their thresholds.  Build without --use_fast_math:
// the divide is __fdiv_rn.
//
// Plain C interface: the caller passes device pointers, the plan, scratch
// and the CUDA stream; the function returns the first CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kWarps = 8;               // warps of a filter block
constexpr int kThreads = kWarps * 32;   // rows scored per round
constexpr int kMinFresh = 2 * kThreads;  // least fresh keys a buffer holds
constexpr int kRefresh = 16;            // rounds between threshold reads
constexpr int kMergeThreads = 512;
constexpr int kSortChunk = 8192;        // keys a sort block holds
constexpr int kSortThreads = 512;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ u64 make_key(float s, int row) {
  return (static_cast<u64>(__float_as_uint(s)) << 32) |
         static_cast<unsigned>(0x7FFFFFFF - row);
}

__device__ __forceinline__ void put(float* out_s, int* out_i, int64_t at,
                                    u64 key) {
  if (key == 0) {
    out_s[at] = -1.0f;
    out_i[at] = -1;
  } else {
    out_s[at] = __uint_as_float(static_cast<unsigned>(key >> 32));
    out_i[at] = 0x7FFFFFFF - static_cast<int>(static_cast<unsigned>(key));
  }
}

// Index of the t-th pair (i, i | j) with bit j of i clear (j a power of 2).
__device__ __forceinline__ int64_t pair_lo(int64_t t, int64_t j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// One compare-exchange of a bitonic network: the larger key to i when
// `desc`, else to i | j.
__device__ __forceinline__ void cex(u64* a, int64_t i, int64_t j, bool desc) {
  const u64 x = a[i], y = a[i | j];
  if (desc ? x < y : x > y) {
    a[i] = y;
    a[i | j] = x;
  }
}

__device__ __forceinline__ int log2i(int x) { return 31 - __clz(x); }

// Barrier of a team of `nthr` threads (whole warps): a warp's own, or named
// barrier `id` (1 and up; 0 is __syncthreads').
__device__ __forceinline__ void team_sync(int id, int nthr) {
  if (nthr == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthr) : "memory");
}

// A team of nthr threads (tid its own index), converged: fold the c fresh
// keys f[0, c) into the sorted kept list a[0, P).  The buffer, padded with 0
// to a power of 2 (len), is cut into runs of m = min(P, len) keys, each
// sorted descending, and a tree of pairwise folds keeps the best run's worth
// (the best m keys, sorted, in f[0, m)); then a[i] = max(a[i], f reversed)
// holds the best P of both as a bitonic sequence, which the merge sorts.
// The runs keep a small P's fold at O(len log^2 P), not O(len log^2 len).
__device__ void team_fold(u64* a, int p, u64* f, int c, int tid, int nthr,
                          int bar) {
  if (c == 0) return;
  int len = 32;
  while (len < c) len <<= 1;
  const int m = min(p, len);
  const int lm = log2i(m);
  for (int t = c + tid; t < len; t += nthr) f[t] = 0;
  team_sync(bar, nthr);
  for (int size = 2; size <= m; size <<= 1) {  // every run sorted descending
    const int dir = size & (m - 1);            // 0 at size m: all descending
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < (len >> 1); t += nthr) {
        const int i = static_cast<int>(pair_lo(t, j));
        cex(f, i, j, (i & dir) == 0);
      }
      team_sync(bar, nthr);
    }
  }
  for (int h = m; h < len; h <<= 1) {  // run at 2hx absorbs the run at 2hx + h
    const int pairs = len / (2 * h);
    for (int t = tid; t < pairs * m; t += nthr) {
      u64* r = f + 2 * h * (t >> lm);
      const int i = t & (m - 1);
      const u64 y = r[h + m - 1 - i];
      if (r[i] < y) r[i] = y;
    }
    team_sync(bar, nthr);
    for (int j = m >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < pairs * (m >> 1); t += nthr)
        cex(f + 2 * h * (t >> (lm - 1)), pair_lo(t & ((m >> 1) - 1), j), j,
            true);
      team_sync(bar, nthr);
    }
  }
  for (int t = tid; t < m; t += nthr) {
    const u64 y = f[m - 1 - t];
    if (a[p - m + t] < y) a[p - m + t] = y;
  }
  team_sync(bar, nthr);
  for (int j = p >> 1; j > 0; j >>= 1) {
    for (int t = tid; t < (p >> 1); t += nthr)
      cex(a, pair_lo(t, j), j, true);
    team_sync(bar, nthr);
  }
}

// W4: the row's 16-byte words when known at compile time (W = 4 W4), 0 for
// 16-byte loads of any W % 4 == 0, -1 for 4-byte loads
template <int QPB, int W4>
__device__ __forceinline__ void
filter_body(const uint32_t* __restrict__ db, const int* __restrict__ dbc,
            const uint32_t* __restrict__ q, const int* __restrict__ qc, int n,
            int w, int nq, int k, int p, int nf, int n_slices,
            int rows_per_slice, u64* __restrict__ tau_g,
            u64* __restrict__ runs) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sq = reinterpret_cast<uint32_t*>(smem);  // (QPB, w) query words
  u64* kept = reinterpret_cast<u64*>(smem + ((QPB * w * 4 + 15) & ~15));
  u64* fresh = kept + QPB * p;                        // (QPB, nf)
  u64* tau = fresh + QPB * nf;                        // (QPB,)
  int* cnt = reinterpret_cast<int*>(tau + QPB);       // (QPB,)
  int* qcs = cnt + QPB;                               // (QPB,) query counts

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QPB;
  const int nql = min(QPB, nq - q0);
  const int slice = blockIdx.y;

  for (int t = threadIdx.x; t < QPB * w; t += kThreads) {
    const int qi = t / w;
    sq[t] = qi < nql ? q[static_cast<int64_t>(q0 + qi) * w + (t - qi * w)] : 0u;
  }
  for (int t = threadIdx.x; t < QPB * p; t += kThreads) kept[t] = 0;
  if (threadIdx.x < QPB) {
    cnt[threadIdx.x] = 0;
    qcs[threadIdx.x] = threadIdx.x < nql ? qc[q0 + threadIdx.x] : 0;
    tau[threadIdx.x] =
        threadIdx.x < nql ? atomicAdd(tau_g + q0 + threadIdx.x, 0ull) : ~0ull;
  }
  __syncthreads();

  // fold every query's buffer, a team of kWarps / nql warps (rounded down
  // to a power of 2) a query, and publish its threshold
  const int team_lg = nql > 4 ? 0 : nql > 2 ? 1 : nql > 1 ? 2 : 3;
  const int team = warp >> team_lg, team_thr = 32 << team_lg;
  const int tid = threadIdx.x - team * team_thr;
  auto fold = [&]() {
    if (team >= nql) return;
    team_fold(kept + team * p, p, fresh + team * nf, cnt[team], tid,
              team_thr, 1 + team);
    if (tid == 0) {
      cnt[team] = 0;
      const u64 kth = kept[team * p + k - 1];
      // kth > 0: k kept keys reach it, so no key below it is in the answer.
      // The others' thresholds come back at every fold, not only every
      // kRefresh rounds.
      const u64 seen = kth > 0 ? atomicMax(tau_g + q0 + team, kth)
                               : atomicAdd(tau_g + q0 + team, 0ull);
      tau[team] = max(tau[team], max(kth, seen));
    }
  };

  // fold past 2P fresh keys (a small P's first fold after one round), and
  // always before a round (at most kThreads keys a query) could overflow
  // the buffer of nf
  const int mark = min(nf - kThreads, 2 * p);
  const int64_t lo64 = static_cast<int64_t>(slice) * rows_per_slice;
  const int64_t row_lo = lo64 < n ? lo64 : n;
  const int64_t row_hi =
      lo64 + rows_per_slice < n ? lo64 + rows_per_slice : n;
  int round = 0;
  for (int64_t r0 = row_lo; r0 < row_hi; r0 += kThreads, ++round) {
    const int64_t base = r0 + warp * 32;
    bool need = false;
    if (base < row_hi) {  // uniform across the warp
      const bool valid = base + lane < row_hi;
      const int row = valid ? static_cast<int>(base + lane) : 0;
      int acc[QPB];
#pragma unroll
      for (int qi = 0; qi < QPB; ++qi) acc[qi] = 0;
      int dcount = 0;
      if (valid) {
        dcount = __ldg(dbc + row);
        if (W4 > 0) {  // the row's words all in flight at once
          const uint4* d4 = reinterpret_cast<const uint4*>(
              db + static_cast<int64_t>(row) * (4 * W4));
          const uint4* q4 = reinterpret_cast<const uint4*>(sq);
          uint4 d[W4 > 0 ? W4 : 1];
#pragma unroll
          for (int c = 0; c < W4; ++c) d[c] = __ldg(d4 + c);
#pragma unroll
          for (int c = 0; c < W4; ++c) {
#pragma unroll
            for (int qi = 0; qi < QPB; ++qi) {
              const uint4 x = q4[qi * W4 + c];
              acc[qi] += __popc(d[c].x & x.x) + __popc(d[c].y & x.y) +
                         __popc(d[c].z & x.z) + __popc(d[c].w & x.w);
            }
          }
        } else if (W4 == 0) {
          const int w4 = w >> 2;
          const uint4* d4 = reinterpret_cast<const uint4*>(
              db + static_cast<int64_t>(row) * w);
          const uint4* q4 = reinterpret_cast<const uint4*>(sq);
          for (int c = 0; c < w4; ++c) {
            const uint4 d = __ldg(d4 + c);
#pragma unroll
            for (int qi = 0; qi < QPB; ++qi) {
              const uint4 x = q4[qi * w4 + c];
              acc[qi] += __popc(d.x & x.x) + __popc(d.y & x.y) +
                         __popc(d.z & x.z) + __popc(d.w & x.w);
            }
          }
        } else {
          const uint32_t* d1 = db + static_cast<int64_t>(row) * w;
          for (int c = 0; c < w; ++c) {
            const uint32_t d = __ldg(d1 + c);
#pragma unroll
            for (int qi = 0; qi < QPB; ++qi)
              acc[qi] += __popc(d & sq[qi * w + c]);
          }
        }
      }
#pragma unroll
      for (int qi = 0; qi < QPB; ++qi) {
        if (qi >= nql) break;  // uniform across the block
        const int u = qcs[qi] + dcount - acc[qi];
        const float score =
            u > 0 ? __fdiv_rn(static_cast<float>(acc[qi]), static_cast<float>(u))
                  : 0.0f;
        const u64 key = make_key(score, row);
        // tau only changes between the block's barriers: a broadcast read
        // here keeps 2 QPB registers free for the scan
        const bool cand = valid && key > tau[qi];
        const unsigned m = __ballot_sync(kFull, cand);
        if (m) {
          int at = 0;
          if (lane == 0) at = atomicAdd(cnt + qi, __popc(m));
          at = __shfl_sync(kFull, at, 0);
          if (cand)
            fresh[qi * nf + at + __popc(m & ((1u << lane) - 1u))] = key;
          need = need || at + __popc(m) > mark;
        }
      }
    }
    // a round appends at most kThreads keys a query: fold before a buffer
    // could overflow, and read the other slices' thresholds now and then
    const bool full = __syncthreads_or(need);
    if (full || round % kRefresh == kRefresh - 1) {
      if (full) {
        fold();
      } else if (threadIdx.x < nql) {
        tau[threadIdx.x] =
            max(tau[threadIdx.x], atomicAdd(tau_g + q0 + threadIdx.x, 0ull));
      }
      __syncthreads();
    }
  }

  fold();
  __syncthreads();
  for (int t = threadIdx.x; t < nql * k; t += kThreads) {
    const int qi = t / k, j = t - qi * k;
    runs[(static_cast<int64_t>(q0 + qi) * n_slices + slice) * k + j] =
        kept[qi * p + j];
  }
}

#define TANI_FILTER_PARAMS                                                   \
  const uint32_t *__restrict__ db, const int *__restrict__ dbc,             \
      const uint32_t *__restrict__ q, const int *__restrict__ qc, int n,    \
      int w, int nq, int k, int p, int nf, int n_slices, int rows_per_slice, \
      u64 *__restrict__ tau_g, u64 *__restrict__ runs
#define TANI_FILTER_FORWARD \
  db, dbc, q, qc, n, w, nq, k, p, nf, n_slices, rows_per_slice, tau_g, runs

template <int QPB, int W4>
__global__ void __launch_bounds__(kThreads) tani_filter(TANI_FILTER_PARAMS) {
  filter_body<QPB, W4>(TANI_FILTER_FORWARD);
}

// At its own choice of registers (48 a thread) ptxas spills one in
// <1, -1> and <2, 0>; allowed the whole register file (one block an SM at
// least) it spills nothing there.  Naming the blocks an SM holds for every
// instance instead spilled in five, and one block for all slowed the tie
// flood 1.8x (an H100 80GB HBM3 at 700 W), so only these two take it.
template <int QPB, int W4>
constexpr bool kWideFilter = (QPB == 1 && W4 == -1) || (QPB == 2 && W4 == 0);

template <int QPB, int W4>
__global__ void __launch_bounds__(kThreads, 1)
tani_filter_wide(TANI_FILTER_PARAMS) {
  filter_body<QPB, W4>(TANI_FILTER_FORWARD);
}
#undef TANI_FILTER_FORWARD
#undef TANI_FILTER_PARAMS

// A block per query: fold its n_slices sorted runs of k keys into one
// sorted list, `slots` (a power of 2) lists of p keys at a time.
__global__ void __launch_bounds__(kMergeThreads)
tani_merge_runs(const u64* __restrict__ runs, int n_slices, int k, int p,
                int slots, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ u64 lists[];  // (slots, p); list 0 is the result
  const int64_t qrow = blockIdx.x;
  const u64* in = runs + qrow * n_slices * k;
  const int half = p >> 1;

  // lists [s0, s1) <- runs r0, r0 + 1, ... (0 past the last run); each
  // thread has four loads in flight
  auto load = [&](int s0, int s1, int r0) {
    const int total = (s1 - s0) * p;
    for (int t0 = threadIdx.x; t0 < total; t0 += 4 * blockDim.x) {
      u64 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * blockDim.x;
        const int run = r0 + t / p, j = t % p;
        v[u] = t < total && run < n_slices && j < k
                   ? in[static_cast<int64_t>(run) * k + j] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * blockDim.x;
        if (t < total) lists[static_cast<int64_t>(s0) * p + t] = v[u];
      }
    }
  };
  load(0, 1, 0);
  for (int next = 1; next < n_slices;) {
    int used = min(slots, 1 + n_slices - next);
    int g = 2;
    while (g < used) g <<= 1;
    load(1, g, next);
    next += used - 1;
    __syncthreads();
    for (int h = 1; h < g; h <<= 1) {  // list 2hm absorbs list 2hm + h
      const int pairs = g / (2 * h);
      for (int t = threadIdx.x; t < pairs * p; t += blockDim.x) {
        u64* a = lists + static_cast<int64_t>(2 * h * (t / p)) * p;
        const int i = t % p;
        const u64 y = a[static_cast<int64_t>(h) * p + p - 1 - i];
        if (a[i] < y) a[i] = y;
      }
      __syncthreads();
      for (int j = half; j > 0; j >>= 1) {
        for (int t = threadIdx.x; t < pairs * half; t += blockDim.x) {
          u64* a = lists + static_cast<int64_t>(2 * h * (t / half)) * p;
          cex(a, pair_lo(t % half, j), j, true);
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    put(out_s, out_i, qrow * k + j, lists[j]);
}

// keys[qi, row] for a chunk of queries; rows n..len-1 get 0 (an empty key)
template <bool VEC4>
__global__ void __launch_bounds__(256)
tani_keys(const uint32_t* __restrict__ db, const int* __restrict__ dbc,
          const uint32_t* __restrict__ q, const int* __restrict__ qc, int n,
          int w, int64_t len, u64* __restrict__ keys) {
  extern __shared__ __align__(16) uint32_t sqw[];  // (w,)
  const int qi = blockIdx.y;
  for (int t = threadIdx.x; t < w; t += blockDim.x)
    sqw[t] = q[static_cast<int64_t>(qi) * w + t];
  __syncthreads();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= len) return;
  u64 key = 0;
  if (row < n) {
    int acc = 0;
    if (VEC4) {
      const uint4* d4 = reinterpret_cast<const uint4*>(db + row * w);
      const uint4* q4 = reinterpret_cast<const uint4*>(sqw);
      for (int c = 0; c < (w >> 2); ++c) {
        const uint4 d = __ldg(d4 + c);
        const uint4 x = q4[c];
        acc += __popc(d.x & x.x) + __popc(d.y & x.y) + __popc(d.z & x.z) +
               __popc(d.w & x.w);
      }
    } else {
      for (int c = 0; c < w; ++c) acc += __popc(__ldg(db + row * w + c) & sqw[c]);
    }
    const int u = qc[qi] + __ldg(dbc + row) - acc;
    const float score =
        u > 0 ? __fdiv_rn(static_cast<float>(acc), static_cast<float>(u)) : 0.0f;
    key = make_key(score, static_cast<int>(row));
  }
  keys[static_cast<int64_t>(qi) * len + row] = key;
}

// Bitonic stages inside a block of `chunk` keys (each query's `len` keys are
// a whole number of chunks): size 0 sorts the chunk through every size up
// to `chunk`; a size above `chunk` runs that size's strides below `chunk`.
// The direction of a pair follows its index within the query's keys, so
// the last size sorts each query descending.
__global__ void __launch_bounds__(kSortThreads)
bitonic_local(u64* __restrict__ keys, int64_t len, int chunk, int64_t size) {
  extern __shared__ u64 part[];  // (chunk,)
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t at = base % len;
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) part[t] = keys[base + t];
  __syncthreads();
  auto stage = [&](int64_t sz, int j) {
    for (int t = threadIdx.x; t < (chunk >> 1); t += blockDim.x) {
      const int64_t i = pair_lo(t, j);
      cex(part, i, j, ((at + i) & sz) == 0);
    }
    __syncthreads();
  };
  if (size == 0) {
    for (int sz = 2; sz <= chunk; sz <<= 1)
      for (int j = sz >> 1; j > 0; j >>= 1) stage(sz, j);
  } else {
    for (int j = chunk >> 1; j > 0; j >>= 1) stage(size, j);
  }
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) keys[base + t] = part[t];
}

// One bitonic stage of stride j >= chunk over (queries, len) keys.
__global__ void __launch_bounds__(256)
bitonic_global(u64* __restrict__ keys, int64_t len, int64_t pairs,
               int64_t size, int64_t j) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const int64_t i = pair_lo(t, j);
  cex(keys, i, j, ((i & (len - 1)) & size) == 0);
}

// out[qi, j] = the j-th key of query qi's sorted keys, pads past n
__global__ void __launch_bounds__(256)
tani_write(const u64* __restrict__ keys, int64_t len, int n, int k,
           float* __restrict__ out_s, int* __restrict__ out_i) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const int64_t qi = blockIdx.y;
  put(out_s, out_i, qi * k + j, j < n ? keys[qi * len + j] : 0ull);
}

template <int QPB, int W4>
cudaError_t launch_filter(const uint32_t* db, const int* dbc, const uint32_t* q,
                          const int* qc, int n, int w, int nq, int k, int p,
                          int nf, int n_slices, int rows_per_slice,
                          size_t smem, u64* tau_g, u64* runs,
                          cudaStream_t stream) {
  auto* kernel = [] {
    if constexpr (kWideFilter<QPB, W4>) return tani_filter_wide<QPB, W4>;
    else return tani_filter<QPB, W4>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + QPB - 1) / QPB, n_slices);
  kernel<<<grid, kThreads, smem, stream>>>(
      db, dbc, q, qc, n, w, nq, k, p, nf, n_slices, rows_per_slice, tau_g,
      runs);
  return cudaGetLastError();
}

size_t filter_smem(int qpb, int w, int p, int nf) {
  return ((static_cast<size_t>(qpb) * w * 4 + 15) & ~static_cast<size_t>(15)) +
         static_cast<size_t>(qpb) * (p + nf) * 8 + qpb * (8 + 4 + 4);
}

constexpr size_t kSmemLimit = 232448;

bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// Shapes: db (n, w), dbc (n,), q (nq, w), qc (nq,); out (nq, k).
// route 0, "filter": qpb in {1, 2, 4, 8}, width = P (a power of 2, k <= P),
//   fresh keys a query's buffer holds (a power of 2 >= 512), slots (a power
//   of 2 >= 2) lists in stage 2; scratch holds nq thresholds then the
//   (nq, n_slices, k) runs, all 8-byte keys.
// route 1, "sort": width = len (a power of 2 >= n), query_chunk queries a
//   pass; scratch holds (query_chunk, len) keys.
// Returns a cudaError_t (0 on success; 1 = invalid value for a plan this
// file does not build).
extern "C" int tanimoto_topk_launch(const void* db, const void* dbc,
                                    const void* q, const void* qc, int n,
                                    int w, int nq, int k, int route, int qpb,
                                    int n_slices, int rows_per_slice,
                                    long long width, int fresh, int slots,
                                    int query_chunk, void* scratch,
                                    void* out_s, void* out_i, void* stream) {
  if (nq <= 0 || n <= 0 || k <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const uint32_t*>(db);
  const auto* dc = static_cast<const int*>(dbc);
  const auto* qq = static_cast<const uint32_t*>(q);
  const auto* qcc = static_cast<const int*>(qc);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  auto* keys = static_cast<u64*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  // 16-byte row loads need 16-byte aligned rows
  const bool vec4 =
      (w % 4) == 0 && (reinterpret_cast<uintptr_t>(db) % 16) == 0;
  cudaError_t err;

  if (route == 0) {
    const int p = static_cast<int>(width);
    const size_t smem = filter_smem(qpb, w, p, fresh);
    const size_t merge_smem = static_cast<size_t>(slots) * p * 8;
    if (!pow2(p) || p < 32 || k > p || !pow2(fresh) || fresh < kMinFresh ||
        n_slices <= 0 || rows_per_slice <= 0 ||
        !pow2(slots) || slots < 2 || smem > kSmemLimit ||
        merge_smem > kSmemLimit)
      return static_cast<int>(cudaErrorInvalidValue);
    u64* tau_g = keys;
    u64* runs = keys + nq;
    err = cudaMemsetAsync(tau_g, 0, sizeof(u64) * nq, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    // W = 32 (the store's fingerprints): all 8 loads of a row in flight at
    // once, which hides their latency where few warps share an SM
    const int w4 = !vec4 ? -1 : w == 32 ? 8 : 0;
#define TANI_ARGS                                                      \
  d, dc, qq, qcc, n, w, nq, k, p, fresh, n_slices, rows_per_slice, smem, \
      tau_g, runs, st
#define TANI_FILTER(QPB_)                                     \
  err = w4 < 0    ? launch_filter<QPB_, -1>(TANI_ARGS)        \
        : w4 == 8 ? launch_filter<QPB_, 8>(TANI_ARGS)         \
                  : launch_filter<QPB_, 0>(TANI_ARGS)
    switch (qpb) {
      case 8: TANI_FILTER(8); break;
      case 4: TANI_FILTER(4); break;
      case 2: TANI_FILTER(2); break;
      case 1: TANI_FILTER(1); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef TANI_FILTER
#undef TANI_ARGS
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(tani_merge_runs,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(merge_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    tani_merge_runs<<<nq, kMergeThreads, merge_smem, st>>>(runs, n_slices, k,
                                                           p, slots, os, oi);
    return static_cast<int>(cudaGetLastError());
  }

  if (route != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t len = width;
  if (!pow2(len) || len < n || query_chunk <= 0 ||
      static_cast<size_t>(w) * 4 > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = static_cast<int>(len < kSortChunk ? len : kSortChunk);
  const size_t wsmem = static_cast<size_t>(w) * 4;
  err = cudaFuncSetAttribute(vec4 ? tani_keys<true> : tani_keys<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wsmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bitonic_local,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(chunk * 8));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int q0 = 0; q0 < nq; q0 += query_chunk) {
    const int qn = nq - q0 < query_chunk ? nq - q0 : query_chunk;
    const dim3 kgrid(static_cast<unsigned>((len + 255) / 256), qn);
    if (vec4)
      tani_keys<true><<<kgrid, 256, wsmem, st>>>(
          d, dc, qq + static_cast<int64_t>(q0) * w, qcc + q0, n, w, len, keys);
    else
      tani_keys<false><<<kgrid, 256, wsmem, st>>>(
          d, dc, qq + static_cast<int64_t>(q0) * w, qcc + q0, n, w, len, keys);
    const int64_t total = static_cast<int64_t>(qn) * len;
    const unsigned blocks = static_cast<unsigned>(total / chunk);
    bitonic_local<<<blocks, kSortThreads, chunk * 8, st>>>(keys, len, chunk, 0);
    for (int64_t size = 2 * static_cast<int64_t>(chunk); size <= len;
         size <<= 1) {
      for (int64_t j = size >> 1; j >= chunk; j >>= 1) {
        const int64_t pairs = total >> 1;
        bitonic_global<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0,
                         st>>>(keys, len, pairs, size, j);
      }
      bitonic_local<<<blocks, kSortThreads, chunk * 8, st>>>(keys, len, chunk,
                                                             size);
    }
    const dim3 wgrid((k + 255) / 256, qn);
    tani_write<<<wgrid, 256, 0, st>>>(keys, len, n, k,
                                      os + static_cast<int64_t>(q0) * k,
                                      oi + static_cast<int64_t>(q0) * k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
