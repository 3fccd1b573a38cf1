// hash_mix: the 128-bit mixing digest of packed identifiers, for sm_90a.
//
// Replaces the Pallas kernel `hash_mix_pallas` (body `_hash_mix_kernel`) of
// src/repro/kernels/hash_mix/kernel.py.  (N, W) uint32 rows in, (N, 4)
// uint32 digests out, bit-exact with the reference `hash_mix_ref`.
//
// Bound on an H100: bytes.  Each lane costs ~20 integer operations against
// 4 bytes read, far below the card's operations-per-byte balance, so the
// floor is N * (4W + 16) bytes over the memory rate.
//
// Design: one thread per row.  The thread walks its row's W lanes in order
// (the mix is sequential over lanes), keeps the four accumulators in
// registers and writes its 4 output words once.  Rows are independent, so
// there is no shared state and no synchronisation.  Known weakness: each
// thread reads its own row, so a warp's loads for one lane are 4W bytes
// apart (uncoalesced; sectors are reused from L1 on the following lanes).
// Staging row tiles through shared memory would coalesce them.
//
// Plain C interface: the caller passes device pointers and the CUDA stream;
// the function returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P1 = 0x9E3779B1u;
constexpr uint32_t P2 = 0x85EBCA77u;
constexpr uint32_t P3 = 0xC2B2AE3Du;
constexpr uint32_t P4 = 0x27D4EB2Fu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 15;
  h *= P2;
  h ^= h >> 13;
  h *= P3;
  h ^= h >> 16;
  return h;
}

__global__ void hash_mix_kernel(const uint32_t* __restrict__ x,
                                uint4* __restrict__ out, int64_t n, int w,
                                uint32_t seed) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* xr = x + row * w;
  uint32_t h0 = P1 + seed;
  uint32_t h1 = P2 ^ seed;
  uint32_t h2 = P3 + seed * P1;
  uint32_t h3 = P4 ^ (seed * P2);
  for (int i = 0; i < w; ++i) {
    const uint32_t k = __ldg(xr + i);
    const uint32_t lane = static_cast<uint32_t>(i + 1);
    h0 = rotl(h0 + k * P2, 13) * P1;
    h1 = rotl(h1 ^ ((k + lane) * P3), 17) * P2;
    h2 = rotl(h2 + ((k ^ (lane * P1)) * P4), 11) * P3;
    h3 = rotl(h3 ^ (k * P1), 19) * P4;
  }
  // length injection + cross-lane mix + final avalanche (in this order:
  // each line reads the previous line's result)
  const uint32_t ln = static_cast<uint32_t>(w);
  h0 = avalanche(h0 ^ (ln * P1) ^ rotl(h1, 7));
  h1 = avalanche(h1 ^ (ln * P2) ^ rotl(h2, 12));
  h2 = avalanche(h2 ^ (ln * P3) ^ rotl(h3, 18));
  h3 = avalanche(h3 ^ (ln * P4) ^ rotl(h0, 23));
  out[row] = make_uint4(h0, h1, h2, h3);
}

}  // namespace

extern "C" int hash_mix_launch(const void* x, void* out, long long n, int w,
                               unsigned int seed, void* stream) {
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  hash_mix_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint4*>(out),
      static_cast<int64_t>(n), w, static_cast<uint32_t>(seed));
  return static_cast<int>(cudaGetLastError());
}
