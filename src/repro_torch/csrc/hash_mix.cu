// hash_mix: the 128-bit mixing digest of packed identifiers, for sm_90a.
//
// Replaces the Pallas kernel `hash_mix_pallas` (body `_hash_mix_kernel`) of
// src/repro/kernels/hash_mix/kernel.py.  (N, W) uint32 rows in, (N, 4)
// uint32 digests out, bit-exact with the reference `hash_mix_ref`.  The mix
// is sequential over a row's lanes, so each row belongs to one thread.
//
// Bound on an H100: bytes.  Each lane costs about 15 integer instructions
// (8 of them multiplies) against 4 bytes read, below the card's
// operations-per-byte balance, so the floor is N * (4W + 16) bytes over the
// memory rate.  What kept the first design (one thread reading its own row
// lane by lane) at 3.2x that floor: a warp's load for one lane touched 32
// rows 4W bytes apart, and the sectors it brought in were evicted from L1
// before the row's next lanes used them, so they came again from L2.
//
// Design, route "staged" (W in {32, 64, 128, 256}, a 16-byte aligned
// base): a persistent grid of 128-thread blocks, one row per thread.  A
// block walks tiles of 128 rows; each tile is read in column chunks of 32
// lanes (128 bytes of every row).  The chunk is copied into shared memory
// by 16-byte `cp.async` copies, consecutive threads on consecutive 16 bytes
// of global memory (a warp reads four whole 128-byte lines), through a ring
// of kStages chunks, so the next chunk loads while this one is mixed (a
// ring of 2, 36 KB, ran level with deeper rings on the card and lets six
// blocks share an SM).  Each thread then reads its row's 128 bytes from
// shared memory as eight 16-byte loads.  Layout: row r of a staged chunk starts at r * 144 bytes (128 of
// data and 16 of padding).  A 16-byte shared load is served a quarter warp
// (8 threads) at a time; threads r .. r + 7 read at 144 r + 16 j, which mod
// 128 is 16 (r + j) mod 128: eight distinct 16-byte bank groups, so the
// reads are free of bank conflicts, and so are the copies (8 threads write
// one row's 128 contiguous bytes).  The lane loop is unrolled over the 32
// lanes of a chunk and the chunk count is a template constant.
//
// Route "rowwise" (any other W or alignment): one thread per row walking
// its W lanes with 4-byte loads, the first design.
//
// Plain C interface: the caller passes device pointers and the CUDA stream;
// each function returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P1 = 0x9E3779B1u;
constexpr uint32_t P2 = 0x85EBCA77u;
constexpr uint32_t P3 = 0xC2B2AE3Du;
constexpr uint32_t P4 = 0x27D4EB2Fu;

constexpr int kRowThreads = 256;                 // route "rowwise"
constexpr int kTileRows = 128;                   // route "staged": rows (threads) a block
constexpr int kChunkLanes = 32;                  // lanes of a row per staged chunk
constexpr int kChunkBytes = 4 * kChunkLanes;     // 128
constexpr int kPitch = kChunkBytes + 16;         // bytes per staged row
constexpr int kStages = 2;                       // chunks in the ring
constexpr int kStageBytes = kTileRows * kPitch;  // 18,432
constexpr int kSmemBytes = kStages * kStageBytes;  // 36,864

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

struct Acc {
  uint32_t h0, h1, h2, h3;
};

__device__ __forceinline__ Acc seeded(uint32_t seed) {
  return {P1 + seed, P2 ^ seed, P3 + seed * P1, P4 ^ (seed * P2)};
}

// lane numbers are 1-based, as in the reference
__device__ __forceinline__ void mix(Acc& a, uint32_t k, uint32_t lane) {
  a.h0 = rotl(a.h0 + k * P2, 13) * P1;
  a.h1 = rotl(a.h1 ^ ((k + lane) * P3), 17) * P2;
  a.h2 = rotl(a.h2 + ((k ^ (lane * P1)) * P4), 11) * P3;
  a.h3 = rotl(a.h3 ^ (k * P1), 19) * P4;
}

// length injection + cross-lane mix + final avalanche (in this order: each
// line reads the previous line's result)
__device__ __forceinline__ uint4 digest(Acc a, uint32_t w) {
  a.h0 = avalanche(a.h0 ^ (w * P1) ^ rotl(a.h1, 7));
  a.h1 = avalanche(a.h1 ^ (w * P2) ^ rotl(a.h2, 12));
  a.h2 = avalanche(a.h2 ^ (w * P3) ^ rotl(a.h3, 18));
  a.h3 = avalanche(a.h3 ^ (w * P4) ^ rotl(a.h0, 23));
  return make_uint4(a.h0, a.h1, a.h2, a.h3);
}

__global__ void __launch_bounds__(kRowThreads)
hash_mix_kernel(const uint32_t* __restrict__ x, uint4* __restrict__ out,
                int64_t n, int w, uint32_t seed) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* xr = x + row * w;
  Acc a = seeded(seed);
  for (int i = 0; i < w; ++i) mix(a, __ldg(xr + i), static_cast<uint32_t>(i + 1));
  out[row] = digest(a, static_cast<uint32_t>(w));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int W>
__global__ void __launch_bounds__(kTileRows)
hash_mix_staged_kernel(const uint32_t* __restrict__ x, uint4* __restrict__ out,
                       int64_t n, uint32_t seed) {
  constexpr int kChunks = W / kChunkLanes;
  constexpr int kPieces = kTileRows * (kChunkBytes / 16);  // 16-byte copies a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t my_tiles =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t steps = my_tiles * kChunks;  // (tile, chunk) pairs, in order

  // copy step g's chunk into ring slot `slot`
  auto load_chunk = [&](int64_t g, int slot) {
    const int64_t tile = blockIdx.x + (g / kChunks) * gridDim.x;
    const int chunk = static_cast<int>(g % kChunks);
    const int64_t row0 = tile * kTileRows;
#pragma unroll
    for (int p = threadIdx.x; p < kPieces; p += kTileRows) {
      const int r = p >> 3;
      const int col = p & 7;
      if (row0 + r < n) {
        cp_async16(smem_base + slot * kStageBytes + r * kPitch + col * 16,
                   x + (row0 + r) * W + chunk * kChunkLanes + col * 4);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_chunk(s, s);
    cp_async_commit();
  }
  int read_slot = 0;
  int write_slot = kStages - 1;
  int64_t g = 0;
  for (int64_t t = 0; t < my_tiles; ++t) {
    Acc a = seeded(seed);
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c, ++g) {
      cp_async_wait<kStages - 2>();  // this thread's copies of step g landed
      __syncthreads();               // everyone's, and slot g - 1 is free
      if (g + kStages - 1 < steps) load_chunk(g + kStages - 1, write_slot);
      cp_async_commit();
      const uint4* row = reinterpret_cast<const uint4*>(
          smem + read_slot * kStageBytes + threadIdx.x * kPitch);
      const uint32_t lane0 = static_cast<uint32_t>(c * kChunkLanes + 1);
#pragma unroll
      for (int v = 0; v < kChunkLanes / 4; ++v) {
        const uint4 k = row[v];
        mix(a, k.x, lane0 + 4 * v);
        mix(a, k.y, lane0 + 4 * v + 1);
        mix(a, k.z, lane0 + 4 * v + 2);
        mix(a, k.w, lane0 + 4 * v + 3);
      }
      read_slot = read_slot == kStages - 1 ? 0 : read_slot + 1;
      write_slot = write_slot == kStages - 1 ? 0 : write_slot + 1;
    }
    const int64_t r = (blockIdx.x + t * gridDim.x) * kTileRows + threadIdx.x;
    if (r < n) out[r] = digest(a, static_cast<uint32_t>(W));
  }
  cp_async_wait<0>();
}

constexpr int kMaxDevices = 16;
// staged grid per device and width (every block that fits); 0 = not yet
int g_blocks[kMaxDevices][4];

template <int W, int Slot>
int launch_staged(const void* x, void* out, long long n, uint32_t seed,
                  cudaStream_t stream) {
  const auto kernel = hash_mix_staged_kernel<W>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int& grid = g_blocks[dev][Slot];
  if (grid == 0) {
    int sms = 0, fit = 0;
    if ((err = cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSmemBytes)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &fit, kernel, kTileRows, kSmemBytes)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid = sms * fit;
  }
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const long long blocks = tiles < grid ? tiles : grid;
  kernel<<<static_cast<unsigned int>(blocks), kTileRows, kSmemBytes, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint4*>(out),
      static_cast<int64_t>(n), seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hash_mix_launch(const void* x, void* out, long long n, int w,
                               unsigned int seed, void* stream) {
  const long long blocks = (n + kRowThreads - 1) / kRowThreads;
  hash_mix_kernel<<<static_cast<unsigned int>(blocks), kRowThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint4*>(out),
      static_cast<int64_t>(n), w, static_cast<uint32_t>(seed));
  return static_cast<int>(cudaGetLastError());
}

// route "staged": w in {32, 64, 128, 256} and x 16-byte aligned (the caller
// checks both; anything else is refused)
extern "C" int hash_mix_staged_launch(const void* x, void* out, long long n,
                                      int w, unsigned int seed, void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sd = static_cast<uint32_t>(seed);
  switch (w) {
    case 32: return launch_staged<32, 0>(x, out, n, sd, s);
    case 64: return launch_staged<64, 1>(x, out, n, sd, s);
    case 128: return launch_staged<128, 2>(x, out, n, sd, s);
    case 256: return launch_staged<256, 3>(x, out, n, sd, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
