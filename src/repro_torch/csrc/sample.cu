// sample: one categorical draw per row of logits, jax.random's way, for sm_90a.
//
// Replaces no Pallas kernel.  The reference samples inside its jitted decode
// step, where XLA fuses `jax.random.categorical` (src/repro/serve/engine.py
// `fused`, src/repro/serve/scheduler.py `sample_rows`): threefry-2x32 bits,
// a uniform, Gumbel noise added to the scaled logits, an argmax.  This kernel
// computes the same function in one pass over (R, V) logits, float32 or
// bfloat16, so that the port's sampled tokens are the reference's.  Its plain
// version, `kernels/sample/ref.py` `sample_ref`, says what each step is and
// why it matches the reference bit for bit.
//
// Per row: the key, given (one for all rows, split first or not, or one per
// row) or derived from the row's seed and token index by
// fold_in(prng_key(seed), index); the element counter, row * V + j under one
// key for all rows (the static engine's categorical over the whole batch), j
// otherwise; the temperature's reciprocal; an optional top-k threshold.  Per
// element, in registers: threefry of the counter, the uniform from the
// mantissa bits, -log(-log(u)), the scaled logit, their sum, the mask; then
// the first maximum.  The draw's dtype is float32 or bfloat16 (the latter
// rounds after each op and draws 8 bits, as the reference's bfloat16 draw
// does), independent of the logits' storage type.  logf, never __logf: no fast
// math.  Products and sums go through __fmul_rn / __fadd_rn so that nvcc
// cannot contract them into a fused multiply-add the reference does not do.
//
// Bound on an H100: operations.  Each element costs about 81 32-bit integer
// operations of threefry (20 rounds of add, rotate, xor, and 5 key
// injections) against 2 or 4 bytes read, far above the card's
// operations-per-byte balance.  Design: rows are split into chunks, so that
// R x G blocks of 256 threads fill the 132 SMs even at a batch of 8 (one
// block a row would use 8); each thread walks its chunk's elements with a
// stride of 256 (coalesced loads), keeps its first maximum, and the block
// reduces (score, index) pairs by warp shuffles.  A second launch of one warp
// per row reduces the G partial maxima.  Ties go to the smaller index at
// every level, so the result is the first maximum whatever the order.
//
// A check may pass two (R, V) buffers that the first launch fills with each
// element's random bits and uniform (null in serving).
//
// Plain C interface: the caller passes device pointers and the CUDA stream;
// the function returns cudaGetLastError() after the launches.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTiny = 1.17549435e-38f;  // 2^-126: float32's and bfloat16's tiny

struct Pair {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void rounds_a(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, 13); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, 15); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, 26); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, 6);  x1 ^= x0;
}

__device__ __forceinline__ void rounds_b(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, 17); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, 29); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, 16); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, 24); x1 ^= x0;
}

// threefry-2x32, 20 rounds (jax._src.prng._threefry2x32_lowering)
__device__ __forceinline__ Pair threefry(uint32_t k0, uint32_t k1, uint32_t x0,
                                         uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds_a(x0, x1); x0 += k1; x1 += k2 + 1u;
  rounds_b(x0, x1); x0 += k2; x1 += k0 + 2u;
  rounds_a(x0, x1); x0 += k0; x1 += k1 + 3u;
  rounds_b(x0, x1); x0 += k1; x1 += k2 + 4u;
  rounds_a(x0, x1); x0 += k2; x1 += k0 + 5u;
  return {x0, x1};
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// uniform(tiny, 1) of the draw's dtype from 32 random bits: the mantissa's
// bits under the exponent of 1.0, minus 1; u is 0 or at least 2^-23, so
// u * 1 + tiny clamped at tiny is max(u, tiny)
template <bool kBf16>
__device__ __forceinline__ float uniform_of(uint32_t bits) {
  float u;
  if (kBf16) {  // 8 random bits, 7 of them in the mantissa
    u = __uint_as_float((((bits & 0xFFu) >> 1) | 0x3F80u) << 16) - 1.0f;
  } else {
    u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  }
  return fmaxf(u, kTiny);
}

// Gumbel noise (mode "low") of the draw's dtype from its uniform
template <bool kBf16>
__device__ __forceinline__ float gumbel_of(float u) {
  if (kBf16) return -bf16_round(logf(bf16_round(-logf(u))));
  return -logf(-logf(u));
}

// (s, i) beats (t, j): a larger score, or an equal one at a smaller index;
// NaN above everything, as torch.argmax and jnp.argmax take it
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  const bool sn = s != s, tn = t != t;
  if (sn || tn) return sn && (!tn || i < j);
  return s > t || (s == t && i < j);
}

__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float t = __shfl_down_sync(0xFFFFFFFFu, s, off);
    const int j = __shfl_down_sync(0xFFFFFFFFu, i, off);
    if (better(t, j, s, i)) { s = t; i = j; }
  }
}

template <typename In, bool kBf16>
__global__ void __launch_bounds__(kThreads) sample_partial_kernel(
    const In* __restrict__ logits, long long row_stride, int vocab, int chunk,
    const uint32_t* __restrict__ keys, int key_stride, int split,
    uint32_t* __restrict__ key_next, const uint32_t* __restrict__ seeds,
    const uint32_t* __restrict__ index, int flat, float inv_t,
    const float* __restrict__ kth, float* __restrict__ part_score,
    int* __restrict__ part_idx, uint32_t* __restrict__ bits_out,
    float* __restrict__ unif_out) {
  const int row = blockIdx.y;
  const int part = blockIdx.x;
  uint32_t k0, k1;
  if (seeds != nullptr) {  // fold_in(prng_key(seed), index); prng_key = [0, seed]
    const Pair k = threefry(0u, seeds[row], 0u, index[row]);
    k0 = k.a; k1 = k.b;
  } else {
    k0 = keys[(long long)row * key_stride];
    k1 = keys[(long long)row * key_stride + 1];
    if (split) {  // key, sub = split(key): the draw uses sub
      if (key_next != nullptr && row == 0 && part == 0 && threadIdx.x == 0) {
        const Pair n = threefry(k0, k1, 0u, 0u);
        key_next[0] = n.a;
        key_next[1] = n.b;
      }
      const Pair s = threefry(k0, k1, 0u, 1u);
      k0 = s.a; k1 = s.b;
    }
  }
  const unsigned long long base = flat ? (unsigned long long)row * (unsigned)vocab : 0ull;
  const float thr = kth != nullptr ? kth[row] : -INFINITY;
  const In* src = logits + (long long)row * row_stride;
  const int end = min(vocab, (part + 1) * chunk);

  float best = -INFINITY;
  int best_i = INT_MAX;
  for (int j = part * chunk + threadIdx.x; j < end; j += kThreads) {
    const unsigned long long c = base + (unsigned long long)j;
    const Pair b = threefry(k0, k1, (uint32_t)(c >> 32), (uint32_t)c);
    const float u = uniform_of<kBf16>(b.a ^ b.b);
    if (bits_out != nullptr) {  // the check's copy of the noise's inputs
      bits_out[(long long)row * vocab + j] = b.a ^ b.b;
      unif_out[(long long)row * vocab + j] = u;
    }
    const float g = gumbel_of<kBf16>(u);
    float l = __fmul_rn(to_float(src[j]), inv_t);
    if (kBf16) l = bf16_round(l);
    float s = __fadd_rn(g, l);
    if (kBf16) s = bf16_round(s);
    if (l < thr) s = -INFINITY;
    if (better(s, j, best, best_i)) { best = s; best_i = j; }
  }

  __shared__ float s_score[kWarps];
  __shared__ int s_idx[kWarps];
  warp_best(best, best_i);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { s_score[warp] = best; s_idx[warp] = best_i; }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? s_score[lane] : -INFINITY;
    best_i = lane < kWarps ? s_idx[lane] : INT_MAX;
    warp_best(best, best_i);
    if (lane == 0) {
      part_score[(long long)row * gridDim.x + part] = best;
      part_idx[(long long)row * gridDim.x + part] = best_i;
    }
  }
}

__global__ void __launch_bounds__(32) sample_final_kernel(
    const float* __restrict__ part_score, const int* __restrict__ part_idx,
    int parts, int* __restrict__ out) {
  const int row = blockIdx.x;
  float best = -INFINITY;
  int best_i = INT_MAX;
  for (int p = threadIdx.x; p < parts; p += 32) {
    const float s = part_score[(long long)row * parts + p];
    const int i = part_idx[(long long)row * parts + p];
    if (better(s, i, best, best_i)) { best = s; best_i = i; }
  }
  warp_best(best, best_i);
  if (threadIdx.x == 0) out[row] = best_i;
}

template <typename In, bool kBf16>
void launch_partial(dim3 grid, cudaStream_t st, const void* logits,
                    long long row_stride, int vocab, int chunk, const void* keys,
                    int key_stride, int split, void* key_next, const void* seeds,
                    const void* index, int flat, float inv_t, const void* kth,
                    void* part_score, void* part_idx, void* bits_out, void* unif_out) {
  sample_partial_kernel<In, kBf16><<<grid, kThreads, 0, st>>>(
      static_cast<const In*>(logits), row_stride, vocab, chunk,
      static_cast<const uint32_t*>(keys), key_stride, split,
      static_cast<uint32_t*>(key_next), static_cast<const uint32_t*>(seeds),
      static_cast<const uint32_t*>(index), flat, inv_t,
      static_cast<const float*>(kth), static_cast<float*>(part_score),
      static_cast<int*>(part_idx), static_cast<uint32_t*>(bits_out),
      static_cast<float*>(unif_out));
}

}  // namespace

extern "C" int sample_launch(const void* logits, int in_bf16, int draw_bf16,
                             int rows, int vocab, long long row_stride,
                             const void* keys, int key_stride, int split,
                             void* key_next, const void* seeds, const void* index,
                             int flat, float inv_t, const void* kth,
                             void* part_score, void* part_idx, int parts, int chunk,
                             void* out, void* bits_out, void* unif_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(parts, rows);
  if (in_bf16 && draw_bf16) {
    launch_partial<__nv_bfloat16, true>(grid, st, logits, row_stride, vocab, chunk, keys,
                                        key_stride, split, key_next, seeds, index, flat,
                                        inv_t, kth, part_score, part_idx, bits_out, unif_out);
  } else if (in_bf16) {
    launch_partial<__nv_bfloat16, false>(grid, st, logits, row_stride, vocab, chunk, keys,
                                         key_stride, split, key_next, seeds, index, flat,
                                         inv_t, kth, part_score, part_idx, bits_out, unif_out);
  } else if (draw_bf16) {
    launch_partial<float, true>(grid, st, logits, row_stride, vocab, chunk, keys,
                                key_stride, split, key_next, seeds, index, flat, inv_t,
                                kth, part_score, part_idx, bits_out, unif_out);
  } else {
    launch_partial<float, false>(grid, st, logits, row_stride, vocab, chunk, keys,
                                 key_stride, split, key_next, seeds, index, flat, inv_t,
                                 kth, part_score, part_idx, bits_out, unif_out);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sample_final_kernel<<<rows, 32, 0, st>>>(static_cast<const float*>(part_score),
                                           static_cast<const int*>(part_idx), parts,
                                           static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
