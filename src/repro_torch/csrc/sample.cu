// sample: one categorical draw per row of logits, jax.random's way, for sm_90a.
//
// Replaces no Pallas kernel.  The reference samples inside its jitted decode
// step, where XLA fuses `jax.random.categorical` (src/repro/serve/engine.py
// `fused`, src/repro/serve/scheduler.py `sample_rows`): threefry-2x32 bits,
// a uniform, Gumbel noise added to the scaled logits, the top-k mask
// `lg < kth` of `jax.lax.top_k`, an argmax.  This kernel computes the same
// function in one launch over (R, V) logits, float32 or bfloat16, so that
// the port's sampled tokens are the reference's.  Its plain version,
// `kernels/sample/ref.py` `sample_ref`, says what each step is and why it
// matches the reference bit for bit.
//
// Per row: the key, given (one for all rows, split first or not, or one per
// row) or derived from the row's seed and token index by
// fold_in(prng_key(seed), index); the element counter, row * V + j under one
// key for all rows (the static engine's categorical over the whole batch), j
// otherwise; the temperature's reciprocal; a top-k threshold, given or found
// here.  Per element, in registers: threefry of the counter, the uniform
// from the mantissa bits, -log(-log(u)), the scaled logit, their sum, the
// mask; then the first maximum.  The draw's dtype is float32 or bfloat16
// (the latter rounds after each op and draws 8 bits, as the reference's
// bfloat16 draw does), independent of the logits' storage type.  logf, never
// __logf: no fast math.  Products and sums go through __fmul_rn / __fadd_rn
// so that nvcc cannot contract them into a fused multiply-add the reference
// does not do.
//
// Bound on an H100: operations.  Each element costs about 81 32-bit integer
// operations of threefry (20 rounds of add, rotate, xor, and 5 key
// injections) against 2 or 4 bytes read, far above the card's
// operations-per-byte balance.
//
// Design: one launch a draw.  Rows are split into chunks, so that R x G
// blocks of 256 threads fill the 132 SMs even at a batch of 8.  Each block
// leaves its chunk's result in a workspace; after a barrier its thread 0
// runs __threadfence() and takes a ticket from atomicAdd on its row's
// arrival counter.  The block that draws the row's last ticket folds the
// row's results, writes the token and sets the counter back to 0, so that
// the next launch, or a CUDA graph's next replay, starts clean (the
// threadfence reduction, with the barrier-then-fence of cooperative
// groups' grid sync: no grid sync, no cooperative launch).  The workspace
// and its zeroed counters belong to the wrapper (kernels/sample/kernel.py),
// one per (device, shape).
//
// * No top-k, or a threshold given (above kTopKCap): a block keeps its first
//   maximum; the folding block takes the first maximum of those.
// * top_k = k <= kTopKCap, the threshold found here.  Scaling is monotone,
//   so the reference's k-th largest scaled logit is the k-th largest of the
//   scaled logits, compared as order-preserving 32-bit keys (-0 as +0, NaN
//   above +inf, as torch.topk and lax.top_k order them).  A block finds its
//   chunk's k-th largest key t_b by radix select (8-bit histogram rounds in
//   shared memory, ended early once the k-th is its bin's largest) and
//   lists its k largest: every element above t_b with its score and index,
//   then elements equal to t_b up to k, by key alone.  Beside the list it
//   keeps the first maximum score among ALL its elements equal to t_b (its
//   tie entry).  Threefry runs only for elements at or above t_b (for the
//   listed ones after the listing, one a thread): the rest are masked
//   whatever the row's threshold.  The folding block selects the k-th
//   largest key of the union of the lists (copied to shared memory where
//   it fits): the row's k largest lie in it, so it is the exact threshold
//   thr (>= every t_b).  The token is the first maximum over the list
//   entries at or above thr and the tie entries of the blocks whose t_b
//   equals thr.  That covers a chunk with more than k logits at or above
//   thr: its extra logits all equal thr = t_b, and its tie entry holds the
//   best of them, as the reference keeps every logit not below kth.
//   thr = NaN masks nothing.
// * Ties go to the smaller index at every level, so the result is the
//   first maximum whatever the order of arrival.
//
// The static engine's key split is written in place: the last row to fold
// writes split(key)[0] into `keys`.  That is safe only because every block
// reads the old key before it takes its ticket, and the rows' folding
// blocks take a second ticket, so the last of them runs after every block
// of the grid has read it.
//
// A check may pass two (R, V) buffers that get each element's random bits
// and uniform (null in serving); every element is then drawn.
//
// Plain C interface: the caller passes device pointers and the CUDA stream;
// the function returns cudaGetLastError() after the launch.

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTopKCap = 256;   // the largest k whose threshold is found here
constexpr int kUnroll = 4;      // keys a thread loads before it uses them
constexpr int kFoldKeys = 4096; // listed keys the fold copies to shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kKeyNaN = 0xFFFFFFFFu;  // every NaN's key, above +inf's
constexpr uint32_t kNoKth = 0u;  // below every logit's key: a chunk of at most k
constexpr float kTiny = 1.17549435e-38f;  // 2^-126: float32's and bfloat16's tiny
static_assert(kThreads == 256, "block_select gives each thread one of 256 bins");

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

// the logit times the temperature's reciprocal, in the draw's dtype
template <typename In, bool kBf16>
__device__ __forceinline__ float scaled(const In* src, int j, float inv_t) {
  const float l = __fmul_rn(to_float(src[j]), inv_t);
  return kBf16 ? bf16_round(l) : l;
}

// an order-preserving key of a scaled logit: -0 as +0, every NaN above +inf
__device__ __forceinline__ uint32_t order_key(float l) {
  if (l != l) return kKeyNaN;
  uint32_t b = __float_as_uint(l);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
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
    const float t = __shfl_down_sync(kFull, s, off);
    const int j = __shfl_down_sync(kFull, i, off);
    if (better(t, j, s, i)) { s = t; i = j; }
  }
}

// the block's first maximum of every thread's (s, i), in thread 0
__device__ __forceinline__ void block_best(float& s, int& i, float* s_score, int* s_idx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  warp_best(s, i);
  if (lane == 0) { s_score[warp] = s; s_idx[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? s_score[lane] : -INFINITY;
    i = lane < kWarps ? s_idx[lane] : INT_MAX;
    warp_best(s, i);
  }
  __syncthreads();
}

// a slot for each lane of the warp whose `pred` holds, from one atomicAdd
// on `counter` a warp; every lane of the warp calls it
__device__ __forceinline__ int warp_slot(int* counter, bool pred) {
  const unsigned m = __ballot_sync(kFull, pred);
  if (m == 0u) return 0;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(kFull, base, leader);
  return base + __popc(m & ((1u << lane) - 1u));
}

struct Shared {
  int hist[256];
  uint32_t fold_key[kFoldKeys];  // the row's listed keys, where they fit
  int warp_sum[kWarps];
  int pick[2];       // the chosen bin and how many keys lie above it
  int slot[2];       // list slots taken: above the k-th key, equal to it
  float score[kWarps];
  int idx[kWarps];
  int last;
};

// the block's largest of every thread's v, in every thread
__device__ __forceinline__ uint32_t block_max(uint32_t v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_max_sync(kFull, v);
  if (lane == 0) sh.warp_sum[warp] = static_cast<int>(v);
  __syncthreads();
  v = 0u;
  for (int w = 0; w < kWarps; ++w) v = max(v, static_cast<uint32_t>(sh.warp_sum[w]));
  __syncthreads();
  return v;
}

struct Select {
  uint32_t kth;  // the k-th largest key
  int above;     // how many keys are larger
};

// the k-th largest of the n keys key_at(e), e < n (1 <= k <= n): rounds of
// an 8-bit histogram (shared atomics, kUnroll keys loaded before they are
// counted) over the keys that match the bits found so far, each round's
// bin the one that holds the k-th; once the k-th is the largest key of its
// bin (with random logits, after two rounds) one maximum over that bin
// ends it.  Every thread calls it.  __match_any_sync to merge a warp's
// equal bins cost more than the atomics it saved (a top-k draw at V =
// 64,000: 49 against 30 us, NVIDIA H100 80GB HBM3 at 700 W,
// scripts/sample_timing.py --variants).
template <typename KeyAt>
__device__ Select block_select(int n, int k, KeyAt key_at, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t prefix = 0u, mask = 0u;
  int want = k, above = 0;
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    sh.hist[tid] = 0;
    __syncthreads();
    for (int e0 = tid; e0 < n; e0 += kThreads * kUnroll) {
      uint32_t x[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        x[q] = e0 + q * kThreads < n ? key_at(e0 + q * kThreads) : 0u;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (e0 + q * kThreads < n && (x[q] & mask) == prefix) {
          atomicAdd(&sh.hist[(x[q] >> shift) & 0xFFu], 1);
        }
      }
    }
    __syncthreads();
    // bins from the top: thread t holds bin 255 - t; an inclusive scan
    const int c = sh.hist[255 - tid];
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) sh.warp_sum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += sh.warp_sum[w];
    if (incl >= want && incl - c < want) {
      sh.pick[0] = 255 - tid;
      sh.pick[1] = incl - c;
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(sh.pick[0]) << shift;
    mask |= 0xFFu << shift;
    want -= sh.pick[1];
    above += sh.pick[1];
    __syncthreads();  // pick and warp_sum are rewritten next
    if (want == 1 && shift > 0) {  // the k-th is its bin's largest key
      uint32_t top = 0u;
      for (int e0 = tid; e0 < n; e0 += kThreads * kUnroll) {
        uint32_t x[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          x[q] = e0 + q * kThreads < n ? key_at(e0 + q * kThreads) : 0u;
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          if ((x[q] & mask) == prefix) top = max(top, x[q]);
        }
      }
      return {block_max(top, sh), above};
    }
  }
  return {prefix, above};
}

// the workspace's arrays, carved from one allocation
struct Workspace {
  int* count;          // [R + 1]: each row's arrivals, then the rows folded
  uint32_t* tie_key;   // [R * G] each block's k-th key (top-k draws)
  float* tie_score;    // [R * G] each block's first maximum: of all its
  int* tie_idx;        //   elements, or of those whose key is its k-th
  uint32_t* list_key;  // [R * G * k] each block's k largest (top-k draws)
  float* list_score;
  int* list_idx;
};

size_t carve(uintptr_t base, int rows, int parts, int cap, Workspace* ws) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const uintptr_t p = base + off;
    off += (bytes + 255) & ~static_cast<size_t>(255);
    return p;
  };
  const size_t blocks = static_cast<size_t>(rows) * parts;
  const size_t listed = blocks * static_cast<size_t>(cap);
  ws->count = reinterpret_cast<int*>(take(4 * (static_cast<size_t>(rows) + 1)));
  ws->tie_key = reinterpret_cast<uint32_t*>(take(4 * blocks));
  ws->tie_score = reinterpret_cast<float*>(take(4 * blocks));
  ws->tie_idx = reinterpret_cast<int*>(take(4 * blocks));
  ws->list_key = reinterpret_cast<uint32_t*>(take(4 * listed));
  ws->list_score = reinterpret_cast<float*>(take(4 * listed));
  ws->list_idx = reinterpret_cast<int*>(take(4 * listed));
  return off;
}

struct Args {
  const void* logits;
  long long row_stride;
  int vocab, chunk;
  uint32_t* keys;  // written in place when split
  int key_stride, split;
  const uint32_t* seeds;
  const uint32_t* index;
  int flat;
  float inv_t;
  const float* kth;  // a given threshold per row, or null
  int top_k;         // 0, or the k whose threshold is found here
  Workspace ws;
  int* out;
  uint32_t* bits_out;
  float* unif_out;
};

// the element's score, its bits and uniform copied out for a check
template <bool kBf16>
__device__ __forceinline__ float draw(const Args& a, uint32_t k0, uint32_t k1,
                                      unsigned long long base, int row, int j, float l) {
  const unsigned long long c = base + static_cast<unsigned long long>(j);
  const Pair b = threefry(k0, k1, static_cast<uint32_t>(c >> 32), static_cast<uint32_t>(c));
  const float u = uniform_of<kBf16>(b.a ^ b.b);
  if (a.bits_out != nullptr) {
    a.bits_out[static_cast<long long>(row) * a.vocab + j] = b.a ^ b.b;
    a.unif_out[static_cast<long long>(row) * a.vocab + j] = u;
  }
  const float s = __fadd_rn(gumbel_of<kBf16>(u), l);
  return kBf16 ? bf16_round(s) : s;
}

template <typename In, bool kBf16, bool kTopK>
__global__ void __launch_bounds__(kThreads) sample_kernel(const Args a) {
  __shared__ Shared sh;
  const int row = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  const int tid = threadIdx.x;
  const Workspace& ws = a.ws;

  uint32_t k0, k1, old0 = 0u, old1 = 0u;
  if (a.seeds != nullptr) {  // fold_in(prng_key(seed), index); prng_key = [0, seed]
    const Pair k = threefry(0u, a.seeds[row], 0u, a.index[row]);
    k0 = k.a; k1 = k.b;
  } else {
    old0 = a.keys[static_cast<long long>(row) * a.key_stride];
    old1 = a.keys[static_cast<long long>(row) * a.key_stride + 1];
    k0 = old0; k1 = old1;
    if (a.split) {  // key, sub = split(key): the draw uses sub
      const Pair s = threefry(old0, old1, 0u, 1u);
      k0 = s.a; k1 = s.b;
    }
  }
  const unsigned long long base =
      a.flat ? static_cast<unsigned long long>(row) * static_cast<unsigned>(a.vocab) : 0ull;
  const In* src = static_cast<const In*>(a.logits) + static_cast<long long>(row) * a.row_stride;
  const int begin = part * a.chunk;
  const int end = min(a.vocab, begin + a.chunk);
  const long long blk = static_cast<long long>(row) * parts + part;

  if (!kTopK) {
    const float thr = a.kth != nullptr ? a.kth[row] : -INFINITY;
    float best = -INFINITY;
    int best_i = INT_MAX;
    for (int j = begin + tid; j < end; j += kThreads) {
      const float l = scaled<In, kBf16>(src, j, a.inv_t);
      float s = draw<kBf16>(a, k0, k1, base, row, j, l);
      if (l < thr) s = -INFINITY;
      if (better(s, j, best, best_i)) { best = s; best_i = j; }
    }
    block_best(best, best_i, sh.score, sh.idx);
    if (tid == 0) {
      ws.tie_score[blk] = best;
      ws.tie_idx[blk] = best_i;
    }
  } else {
    const int k = a.top_k, n = end - begin;
    uint32_t kth_b = kNoKth;  // a chunk of at most k lists every element
    int above = 0;
    if (n > k) {
      const Select sel = block_select(
          n, k, [&](int e) { return order_key(scaled<In, kBf16>(src, begin + e, a.inv_t)); },
          sh);
      kth_b = sel.kth;
      above = sel.above;
    }
    if (tid < 2) sh.slot[tid] = 0;
    __syncthreads();
    const long long list0 = blk * k;
    float tb = -INFINITY;
    int ti = INT_MAX;
    for (int j0 = begin; j0 < end; j0 += kThreads) {  // uniform: warp_slot
      const int j = j0 + tid;
      const bool in = j < end;
      const float l = in ? scaled<In, kBf16>(src, j, a.inv_t) : 0.0f;
      const uint32_t key = in ? order_key(l) : kNoKth;
      const bool up = in && key > kth_b;
      const bool tie = in && key == kth_b;
      float s = -INFINITY;  // a check's copy of the noise draws every logit
      if (tie || (in && a.bits_out != nullptr)) s = draw<kBf16>(a, k0, k1, base, row, j, l);
      const int su = warp_slot(&sh.slot[0], up);
      if (up) {  // scored below
        ws.list_key[list0 + su] = key;
        ws.list_idx[list0 + su] = j;
      }
      if (tie && better(s, j, tb, ti)) { tb = s; ti = j; }
      const int sf = warp_slot(&sh.slot[1], tie);
      if (tie && sf < k - above) {  // its key fills the list; the tie entry scores it
        ws.list_key[list0 + above + sf] = key;
        ws.list_score[list0 + above + sf] = -INFINITY;
        ws.list_idx[list0 + above + sf] = INT_MAX;
      }
    }
    for (int i = n + tid; i < k; i += kThreads) {  // a short chunk pads its list
      ws.list_key[list0 + i] = kNoKth;
      ws.list_score[list0 + i] = -INFINITY;
      ws.list_idx[list0 + i] = INT_MAX;
    }
    __syncthreads();
    // the listed logits' scores, one a thread: drawn where they were found,
    // a warp would draw its few listed logits one after another
    for (int t = tid; t < sh.slot[0]; t += kThreads) {
      const int j = __ldcg(ws.list_idx + list0 + t);
      ws.list_score[list0 + t] =
          draw<kBf16>(a, k0, k1, base, row, j, scaled<In, kBf16>(src, j, a.inv_t));
    }
    block_best(tb, ti, sh.score, sh.idx);
    if (tid == 0) {
      ws.tie_key[blk] = kth_b;
      ws.tie_score[blk] = tb;
      ws.tie_idx[blk] = ti;
    }
  }

  // arrival: the block that takes the row's last ticket folds the row.  The
  // barrier orders the block's writes before thread 0's fence and ticket,
  // and the last block fences again before it reads the others' results
  // (the pattern of cooperative groups' grid sync).
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(&ws.count[row], 1) == parts - 1;
    if (last) __threadfence();
    sh.last = last;
  }
  __syncthreads();
  if (!sh.last) return;

  const long long blk0 = static_cast<long long>(row) * parts;
  float best = -INFINITY;
  int best_i = INT_MAX;
  if (!kTopK) {
    for (int p = tid; p < parts; p += kThreads) {
      const float s = __ldcg(ws.tie_score + blk0 + p);
      const int i = __ldcg(ws.tie_idx + blk0 + p);
      if (better(s, i, best, best_i)) { best = s; best_i = i; }
    }
  } else {
    const int k = a.top_k, u = parts * k;
    const uint32_t* lk = ws.list_key + blk0 * k;
    // the select reads every listed key four times or more: from shared
    // memory where they fit, else from L2
    const bool copied = u <= kFoldKeys;
    if (copied) {
      for (int e0 = tid; e0 < u; e0 += kThreads * kUnroll) {
        uint32_t x[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          x[q] = e0 + q * kThreads < u ? __ldcg(lk + e0 + q * kThreads) : 0u;
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          if (e0 + q * kThreads < u) sh.fold_key[e0 + q * kThreads] = x[q];
        }
      }
      __syncthreads();
    }
    const uint32_t thr =
        copied ? block_select(u, k, [&](int e) { return sh.fold_key[e]; }, sh).kth
               : block_select(u, k, [&](int e) { return __ldcg(lk + e); }, sh).kth;
    const bool all = thr == kKeyNaN;  // l < NaN holds for no logit
    for (int e0 = tid; e0 < u; e0 += kThreads * kUnroll) {
      uint32_t x[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int e = e0 + q * kThreads;
        x[q] = e >= u ? 0u : copied ? sh.fold_key[e] : __ldcg(lk + e);
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int e = e0 + q * kThreads;
        if (e < u && (all || x[q] >= thr)) {
          const float s = __ldcg(ws.list_score + blk0 * k + e);
          const int i = __ldcg(ws.list_idx + blk0 * k + e);
          if (better(s, i, best, best_i)) { best = s; best_i = i; }
        }
      }
    }
    for (int p = tid; p < parts; p += kThreads) {  // t_b <= thr: kept where equal
      if (all || __ldcg(ws.tie_key + blk0 + p) >= thr) {
        const float s = __ldcg(ws.tie_score + blk0 + p);
        const int i = __ldcg(ws.tie_idx + blk0 + p);
        if (better(s, i, best, best_i)) { best = s; best_i = i; }
      }
    }
  }
  block_best(best, best_i, sh.score, sh.idx);
  if (tid == 0) {
    a.out[row] = best_i;
    ws.count[row] = 0;  // the next launch or replay starts from zero
    if (a.split) {      // the last row to fold writes the new key
      __threadfence();
      if (atomicAdd(&ws.count[gridDim.y], 1) == static_cast<int>(gridDim.y) - 1) {
        const Pair nk = threefry(old0, old1, 0u, 0u);
        a.keys[0] = nk.a;
        a.keys[1] = nk.b;
        ws.count[gridDim.y] = 0;
      }
    }
  }
}

template <typename In, bool kBf16>
void launch(dim3 grid, cudaStream_t st, const Args& a) {
  if (a.top_k > 0) {
    sample_kernel<In, kBf16, true><<<grid, kThreads, 0, st>>>(a);
  } else {
    sample_kernel<In, kBf16, false><<<grid, kThreads, 0, st>>>(a);
  }
}

}  // namespace

extern "C" int sample_top_k_cap() { return kTopKCap; }

// bytes of the workspace of a draw over R rows in G chunks; `listed`: the
// lists of a top-k draw whose threshold is found here (any k <= the cap)
extern "C" long long sample_workspace_bytes(int rows, int parts, int listed) {
  Workspace ws;
  return static_cast<long long>(carve(0, rows, parts, listed ? kTopKCap : 0, &ws));
}

extern "C" int sample_launch(const void* logits, int in_bf16, int draw_bf16,
                             int rows, int vocab, long long row_stride, void* keys,
                             int key_stride, int split, const void* seeds,
                             const void* index, int flat, float inv_t, const void* kth,
                             int top_k, void* workspace, long long workspace_bytes,
                             int parts, int chunk, void* out, void* bits_out,
                             void* unif_out, void* stream) {
  if (top_k < 0 || top_k > kTopKCap || (top_k > 0 && (top_k >= vocab || kth != nullptr)) ||
      (split && seeds != nullptr) || rows < 1 || parts < 1 ||
      static_cast<long long>(parts) * chunk < vocab) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  const size_t need = carve(reinterpret_cast<uintptr_t>(workspace), rows, parts,
                            top_k > 0 ? kTopKCap : 0, &a.ws);
  if (static_cast<long long>(need) > workspace_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.logits = logits;
  a.row_stride = row_stride;
  a.vocab = vocab;
  a.chunk = chunk;
  a.keys = static_cast<uint32_t*>(keys);
  a.key_stride = key_stride;
  a.split = split;
  a.seeds = static_cast<const uint32_t*>(seeds);
  a.index = static_cast<const uint32_t*>(index);
  a.flat = flat;
  a.inv_t = inv_t;
  a.kth = static_cast<const float*>(kth);
  a.top_k = top_k;
  a.out = static_cast<int*>(out);
  a.bits_out = static_cast<uint32_t*>(bits_out);
  a.unif_out = static_cast<float*>(unif_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(parts, rows);
  if (in_bf16 && draw_bf16) {
    launch<__nv_bfloat16, true>(grid, st, a);
  } else if (in_bf16) {
    launch<__nv_bfloat16, false>(grid, st, a);
  } else if (draw_bf16) {
    launch<float, true>(grid, st, a);
  } else {
    launch<float, false>(grid, st, a);
  }
  return static_cast<int>(cudaGetLastError());
}
