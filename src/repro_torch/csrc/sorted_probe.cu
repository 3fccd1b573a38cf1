// sorted_probe: membership and lower bound of 64-bit keys in a sorted table,
// for sm_90a.
//
// Replaces the Pallas kernel `probe_blocks_pallas` (body `_probe_kernel`) of
// src/repro/kernels/sorted_probe/kernel.py together with its stages A and C
// (`sorted_probe_pallas` and `_fence_assign` in ops.py).  Queries (Q, 2) and
// table (M, 2) are uint32 (hi, lo) pairs, the table sorted ascending
// (duplicates allowed).  Outputs per query: pos (int32) and found (uint8
// 0/1).  pos is the GLOBAL lower bound
// -- the first index whose key is >= the query -- exactly as the reference
// `sorted_probe_ref` defines it, so a duplicate run is always entered at its
// head.
//
// Two routes, chosen once per table by the wrapper (kernel.py `route`).
//
// "direct": one thread per query runs a branch-free lower-bound search over
// the whole table.  Every thread does the same number of steps, so a warp
// never diverges, and each step is one predicated select.  It reads
// ~log2(M) dependent 8-byte words a query, each one sector that few other
// queries share.
//
// "fenced": the reference's fences (stage A: every B_T-th key), in the form
// that suits this card: a static search tree over the table's lines of
// B = kNodeKeys = 8 keys (64 bytes), built once per table that takes this
// route, when the table is made into a ProbeTable (the store does so at
// upload; kernel.py `build_fences`).  The card measured 16-key nodes
// (128 bytes) slower at PubChem's probe (scripts/probe_grid.py --variants
// nodes16).  A node holds B keys and has B + 1 children: slot k is the
// first key of child k + 1 (child 0's first key is implied), so level 1 has
// one node per B + 1 lines, level 2 one per B + 1 level-1 nodes, up to one
// root; slots past the last child hold all-ones keys, which never count
// below a query.  The fences take an eighth of the table.  A group
// of B/2 lanes owns a query and walks the levels from the root: it reads
// one whole node with one 16-byte load a lane, compares the keys with the
// query in registers (strict <, as the direct search does, so a duplicate
// run is entered at its head however it straddles lines and nodes), and
// the count of keys below the query (__ballot_sync and __popc over the
// group's lanes) is the child to take.  The leaf is one line of the table
// itself, read the same way (keys at or past M masked off, never read).
// The found flag needs no further read: the first key >= the query is in
// the node just read, or it is the separator inherited from a level above,
// kept in a register.
//
// What bounds each route on an H100.  Past the 50 MB L2, the direct
// search's last steps: about 5.5 sectors a query that no other query
// shares, each a dependent round trip to DRAM after ~20 dependent L2 hits
// (PubChem's 176,929,690 rows: 0.21 ms for 477,123 queries, ~0.39 TB/s of
// sectors).  The fenced search makes one node read a level and one leaf
// read: at that table, eight levels and a leaf, of which only the
// level-1 node and the leaf line (128 bytes) come from DRAM; the levels
// above (17.5 MB) stay in L2 and the top ones in L1.  It is bound by the
// rate of those random line reads, and by the L2 reads of the upper levels
// that every query repeats.  L2 eviction policies on the fence and leaf
// reads (createpolicy, ld.global.nc.L2::cache_hint) measured no gain and
// are not used (scripts/probe_grid.py --variants l2-hints).
//
// Plain C interface: the caller passes device pointers and the CUDA stream
// (a null `fences` is the direct route); `sorted_probe_launch` returns
// cudaGetLastError() after the launch.  A served request is launch- and
// host-bound (a 32-key search takes the card ~5 us), so `sorted_probe_served`
// does all of it in one call from the host: the copy in from a pinned
// buffer, the launch, the copy out, the wait.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kNodeKeys = 8;  // keys a fence node and a leaf line hold
constexpr int kMaxLevels = 16;  // 8-key nodes and M < 2^31 need 9

__device__ __forceinline__ uint64_t pair_key(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;  // (hi, lo) as unsigned 64
}

__device__ __forceinline__ uint64_t key_at(const uint2* __restrict__ p, int64_t i) {
  const uint2 v = __ldg(p + i);
  return pair_key(v.x, v.y);
}

__global__ void sorted_probe_kernel(const uint2* __restrict__ queries,
                                    const uint2* __restrict__ table,
                                    int32_t* __restrict__ pos,
                                    uint8_t* __restrict__ found, int64_t q,
                                    int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const uint64_t key = key_at(queries, i);
  // Invariant: the answer lies in [base, base + len]; table[base - 1] < key.
  int64_t base = 0;
  int64_t len = m;
  while (len > 1) {
    const int64_t half = len >> 1;
    base = (key_at(table, base + half - 1) < key) ? base + half : base;
    len -= half;
  }
  // len == 1: one candidate left at base (m >= 1 is guaranteed by the caller)
  const uint64_t t = key_at(table, base);
  const int64_t p = base + (t < key ? 1 : 0);
  pos[i] = static_cast<int32_t>(p);
  found[i] = (p < m && key_at(table, p < m ? p : m - 1) == key) ? 1 : 0;
}

// Start of each fence level (in keys), level 1 first; count levels.
struct Levels {
  long long off[kMaxLevels];
  int count;
};

// One node of B keys read by the group (two keys a lane): the count of keys
// below `key`, and the first key not below it when the node holds one.
__device__ __forceinline__ int count_below(uint64_t k0, uint64_t k1,
                                           uint64_t key, unsigned gmask,
                                           int gbase, uint64_t& succ) {
  constexpr int B = kNodeKeys, G = B / 2;
  const unsigned b0 = __ballot_sync(kFull, k0 < key) & gmask;
  const unsigned b1 = __ballot_sync(kFull, k1 < key) & gmask;
  const int cnt = __popc(b0) + __popc(b1);
  const uint64_t mine = (cnt & 1) ? k1 : k0;
  const int src = gbase + ((cnt >> 1) < G ? (cnt >> 1) : G - 1);
  const uint64_t at = __shfl_sync(kFull, mine, src);
  if (cnt < B) succ = at;
  return cnt;
}

__global__ void __launch_bounds__(kThreads)
sorted_probe_fenced_kernel(const uint2* __restrict__ queries,
                           const uint2* __restrict__ table,
                           const uint4* __restrict__ fences,
                           int32_t* __restrict__ pos,
                           uint8_t* __restrict__ found, int64_t q, int64_t m,
                           Levels lv) {
  constexpr int B = kNodeKeys;
  constexpr int G = B / 2;  // lanes a query: 16 bytes, two keys, a lane
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int gbase = lane & ~(G - 1);
  const unsigned gmask = ((1u << G) - 1u) << gbase;
  const int64_t gq =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  // a group past the last query walks the last query's path and stores
  // nothing: every lane of the warp takes part in every ballot
  const uint64_t key = key_at(queries, gq < q ? gq : q - 1);

  int64_t node = 0;
  uint64_t succ = 0;
  for (int l = lv.count - 1; l >= 0; --l) {
    const uint4 v = __ldg(fences + (lv.off[l] + node * B) / 2 + sub);
    const int cnt = count_below(pair_key(v.x, v.y), pair_key(v.z, v.w), key,
                                gmask, gbase, succ);
    node = node * (B + 1) + cnt;  // child cnt of B + 1
  }
  // the leaf: one line of B table keys, keys at or past m masked off (all
  // ones never count below a query)
  const int64_t i0 = node * B + 2 * sub;
  uint64_t k0 = ~0ull, k1 = ~0ull;
  if (i0 + 1 < m) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(table) + i0 / 2);
    k0 = pair_key(v.x, v.y);
    k1 = pair_key(v.z, v.w);
  } else if (i0 < m) {
    k0 = key_at(table, i0);
  }
  const int cnt = count_below(k0, k1, key, gmask, gbase, succ);
  const int64_t p = node * B + cnt;
  if (sub == 0 && gq < q) {
    pos[gq] = static_cast<int32_t>(p);
    // p < m: the first key >= the query exists, and succ holds it
    found[gq] = (p < m && succ == key) ? 1 : 0;
  }
}

cudaError_t launch_fenced(const uint2* queries, const uint2* table,
                          const uint4* fences, int32_t* pos, uint8_t* found,
                          long long q, long long m, cudaStream_t stream) {
  constexpr int B = kNodeKeys;
  Levels lv{};
  long long n = (m + B - 1) / B, at = 0;  // leaf lines
  while (n > 1) {  // kernel.py `fence_levels` builds the same layout
    if (lv.count == kMaxLevels) return cudaErrorInvalidValue;
    n = (n + B) / (B + 1);  // nodes of the level above
    lv.off[lv.count++] = at;
    at += n * B;
  }
  constexpr int kQueries = kThreads / (B / 2);
  const long long blocks = (q + kQueries - 1) / kQueries;
  sorted_probe_fenced_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                               stream>>>(queries, table, fences, pos, found, q,
                                         m, lv);
  return cudaGetLastError();
}

// A launch of either route: a null `fences` is the direct search, else the
// fenced one over them (kernel.py `build_fences`; table and fences 16-byte
// aligned).
cudaError_t launch_route(const uint2* queries, const uint2* table,
                         const void* fences, int32_t* pos, uint8_t* found,
                         long long q, long long m, cudaStream_t stream) {
  if (fences == nullptr) {
    const long long blocks = (q + kThreads - 1) / kThreads;
    sorted_probe_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          stream>>>(queries, table, pos, found, q, m);
    return cudaGetLastError();
  }
  if ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(fences)) % 16)
    return cudaErrorInvalidValue;
  return launch_fenced(queries, table, static_cast<const uint4*>(fences), pos,
                       found, q, m, stream);
}

}  // namespace

// queries (q, 2) and the (m, 2) table on the device, and the table's fences
// or null (the direct route); pos (q) int32 and found (q) uint8 out.
// Returns a cudaError_t (1, invalid value, for an alignment the fenced
// kernel does not take).
extern "C" int sorted_probe_launch(const void* queries, const void* table,
                                   const void* fences, void* pos, void* found,
                                   long long q, long long m, void* stream) {
  return static_cast<int>(launch_route(
      static_cast<const uint2*>(queries), static_cast<const uint2*>(table),
      fences, static_cast<int32_t*>(pos), static_cast<uint8_t*>(found), q, m,
      static_cast<cudaStream_t>(stream)));
}

// The served probe in one call: copy q queries from pinned host memory into
// `buf` (13 q device bytes: the queries, then q int32 positions, then q
// found flags), launch the route, copy the positions and flags (5 q bytes)
// into pinned `host_out`, and wait for the stream.
extern "C" int sorted_probe_served(const void* host_queries, void* buf,
                                   const void* table, const void* fences,
                                   void* host_out, long long q, long long m,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* bytes = static_cast<uint8_t*>(buf);
  cudaError_t err = cudaMemcpyAsync(buf, host_queries, 8 * q,
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_route(static_cast<const uint2*>(buf),
                     static_cast<const uint2*>(table), fences,
                     reinterpret_cast<int32_t*>(bytes + 8 * q), bytes + 12 * q,
                     q, m, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyAsync(host_out, bytes + 8 * q, 5 * q, cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(st));
}
