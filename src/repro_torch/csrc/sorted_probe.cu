// sorted_probe: membership and lower bound of 64-bit keys in a sorted table,
// for sm_90a.
//
// Replaces the Pallas kernel `probe_blocks_pallas` (body `_probe_kernel`) of
// src/repro/kernels/sorted_probe/kernel.py together with its stages A and C
// (`sorted_probe_pallas` and `_fence_assign` in ops.py).  Queries (Q, 2) and
// table (M, 2) are uint32 (hi, lo) pairs, the table sorted ascending
// (duplicates allowed).  Outputs per query: found (uint8 0/1) and pos
// (int32), the GLOBAL lower bound -- the first index whose key is >= the
// query -- exactly as the reference `sorted_probe_ref` defines it, so a
// duplicate run is always entered at its head.
//
// Design: one thread per query runs a branch-free lower-bound search over
// the whole table.  Every thread does the same number of steps, so a warp
// never diverges, and each step is one predicated select.  Dropped from the
// TPU design: the fence bucketing, the dense block compare and the overflow
// fallback.  They exist because dynamic gathers are slow on a TPU; on this
// card a gather is one load.
//
// What bounds it on an H100: not the bytes (the distinct 32-byte sectors
// the searches touch) but the rate at which the memory system serves
// scattered requests: a warp's search step is 32 loads at 32 unrelated
// addresses, and the bottom steps of a table larger than L2 go to DRAM.
// Measured on the card, a persistent grid that runs the top 13 levels of
// the search from a copy in shared memory cut those requests, but paid a
// fill of 8,191 keys per block and kept a quarter of the threads in flight.
// It was faster only for a few hundred thousand queries in one table, a
// shape neither the funnel's per-shard probes nor the service's requests
// send, and slower at every shape they do send; so this one kernel stays.
// At those shapes it is as fast as torch.searchsorted on the device.
//
// Plain C interface: the caller passes device pointers and the CUDA stream;
// the function returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t key_at(const uint2* __restrict__ p, int64_t i) {
  const uint2 v = __ldg(p + i);
  return (static_cast<uint64_t>(v.x) << 32) | v.y;  // (hi, lo) as unsigned 64
}

__global__ void sorted_probe_kernel(const uint2* __restrict__ queries,
                                    const uint2* __restrict__ table,
                                    uint8_t* __restrict__ found,
                                    int32_t* __restrict__ pos, int64_t q,
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

}  // namespace

extern "C" int sorted_probe_launch(const void* queries, const void* table,
                                   void* found, void* pos, long long q,
                                   long long m, void* stream) {
  constexpr int kThreads = 256;
  const long long blocks = (q + kThreads - 1) / kThreads;
  sorted_probe_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(queries), static_cast<const uint2*>(table),
      static_cast<uint8_t*>(found), static_cast<int32_t*>(pos),
      static_cast<int64_t>(q), static_cast<int64_t>(m));
  return static_cast<int>(cudaGetLastError());
}
