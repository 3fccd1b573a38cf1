// ssd_scan: the Mamba2 SSD inter-chunk state scan, for sm_90a.
//
// Replaces the Pallas kernel `ssd_scan_pallas` (body `_ssd_kernel`) of
// src/repro/kernels/ssd_scan/kernel.py.  states (BH, C, P, N) float32 and
// decay (BH, C) float32 in, prefix (BH, C, P, N) float32 out:
//
//   h = 0;  for c in 0..C-1:  prefix[:, c] = h;  h = decay[:, c] * h + states[:, c]
//
// Bound on an H100: bytes.  Each state element costs one multiply and one
// add against 8 bytes moved (read once, its prefix written once), far below
// the card's operations-per-byte balance, so the floor is
// (2 * BH*C*P*N + BH*C) * 4 bytes over the memory rate.
//
// Design: each thread owns 4 consecutive elements of one (bh, P*N) state
// tile as a float4 (one float when P*N is not a multiple of 4 or states is
// not 16-byte aligned) and walks the chunks in order with the carry in
// registers: store the prefix, then update the carry.  The carry never goes
// back to device memory between chunks, which is what the TPU kernel keeps
// in VMEM scratch.  Neighbouring threads own neighbouring elements, so every
// load and store of a warp is coalesced along the contiguous P*N axis.  All
// threads of a block read the same decay[bh, c] (one broadcast load).  The
// loads of later chunks do not depend on the carry, so the unrolled loop
// keeps several in flight.
//
// Rounding: the update is __fadd_rn(__fmul_rn(d, h), s), which nvcc never
// contracts into an FMA, so the kernel matches the plain PyTorch version (a
// separate multiply and add) bit for bit.  Do not build with fast math.
//
// Plain C interface: the caller passes device pointers and the CUDA stream;
// the function returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float step(float d, float h, float s) {
  return __fadd_rn(__fmul_rn(d, h), s);
}

__device__ __forceinline__ float4 step(float d, float4 h, float4 s) {
  return make_float4(step(d, h.x, s.x), step(d, h.y, s.y),
                     step(d, h.z, s.z), step(d, h.w, s.w));
}

// T is float4 (4 elements a thread) or float; `width` is P*N in units of T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ states, const float* __restrict__ decay,
                T* __restrict__ prefix, int c, int64_t width, int64_t tiles) {
  const int64_t bh = blockIdx.x / tiles;
  const int64_t i = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (i >= width) return;
  const int64_t base = bh * c * width + i;
  const T* s = states + base;
  T* out = prefix + base;
  const float* d = decay + bh * c;
  T h{};  // zeros: h[0] = 0
#pragma unroll 4
  for (int j = 0; j < c; ++j) {
    out[j * width] = h;
    h = step(__ldg(d + j), h, __ldg(s + j * width));
  }
}

}  // namespace

extern "C" int ssd_scan_launch(const void* states, const void* decay,
                               void* prefix, long long bh, int c,
                               long long pn, int vec, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const long long width = vec == 4 ? pn / 4 : pn;
  const long long tiles = (width + kThreads - 1) / kThreads;
  const long long blocks = bh * tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec == 4) {
    ssd_scan_kernel<float4><<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
        static_cast<const float4*>(states), static_cast<const float*>(decay),
        static_cast<float4*>(prefix), c, width, tiles);
  } else {
    ssd_scan_kernel<float><<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(states), static_cast<const float*>(decay),
        static_cast<float*>(prefix), c, width, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
