// flash_attention: forward attention with an online softmax (causal and/or
// sliding window, GQA/MQA), for sm_90a.
//
// Replaces the Pallas kernel `flash_attention_pallas` (body `_fa_kernel`) of
// src/repro/kernels/flash_attention/kernel.py.  q (B, Hq, Sq, D) against
// k, v (B, Hkv, Skv, D), in float32 or bfloat16; out (B, Hq, Sq, D) in q's
// dtype, contiguous.  The same function as the port's plain version
// `flash_attention_ref`:
//
//   queries are the last Sq positions of the key stream (off = Skv - Sq);
//   key j is visible to query row i (position p = i + off) when
//     j <= p (causal) and j > p - window (window, when given);
//   query head h reads KV head h / (Hq / Hkv);
//   s = (q * scale) . k in float32, running max m, denominator l and
//   accumulator acc in float32, p = exp(s - m) * visible; out = acc / l,
//   and 0 for a row that sees no key (l == 0), as the Pallas kernel gives.
//
// Bound on an H100: operations.  At the serving path's prefill (yi-6b:
// B = 8, Hq = 32, Hkv = 4, S = 2,048, D = 128, causal) the two products
// are 4 * B * Hq * S^2 * D / 2 = 2.75e11 flops against 302 MB of inputs
// and output: 0.278 ms at the bf16 tensor-core peak (989 TFLOP/s).
//
// Two kernels; the wrapper (kernels/flash_attention/kernel.py `route`)
// picks one before launch:
//
// * `fa_forward_tc`, the tensor-core route: bfloat16 with D a multiple of 8
//   up to 256, and base pointers and strides that TMA accepts.  One block
//   of three warpgroups per (batch x query head, tile of 128 queries).
//   Warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec)
//   and one of its threads loads the Q tile once and the K and V tiles of
//   every visible key tile by TMA (4-D tensor maps over the strided (B, H,
//   S, D) views, 128-byte swizzle, zeros past Skv and past D) into two
//   2-stage rings of bf16 tiles, one for K and one for V, each stage with
//   a full and an empty mbarrier (K frees after Q K^T, V after P V, so a
//   K tile loads while the last P V still reads V).  Warpgroups 1 and 2
//   are consumers of 64 query rows each (setmaxnreg.inc): S = Q K^T by
//   wgmma from shared memory, the online softmax on the accumulator
//   fragment (MUFU exp2 with scale * log2 e folded in; quad shuffles for the
//   row max; masks only on tiles that straddle the causal frontier, the
//   window's lower edge or Skv), and O += P V by wgmma with P converted
//   to bf16 in registers (the accumulator layout is the A-operand layout)
//   and V read MN-major (the transpose bit).  A consumer issues tile j's
//   Q K^T and tile j-1's P V together and runs tile j's softmax while the
//   P V is still on the tensor cores.  l sums the unrounded float32 p.
//   The epilogue divides by l (0 where l == 0) and writes bf16.  No split
//   over keys and no atomics: two launches give the same bits.  Rounding
//   P to bf16 is the one step the plain version does not take; it moves
//   the output by at most 2^-8 sum_j p_j |v_j| / l (the checks in
//   chip_smoke.py and tests/test_torch_cuda.py allow exactly that).
//
// * `fa_forward`, the CUDA-core route: everything else (float32, or bf16
//   that TMA cannot read).  One block of 128 threads per (batch x query
//   head, tile of BQ queries) loops over the key tiles of BK keys that
//   hold a visible key for some row of the tile (the loop takes the place
//   of the TPU's sequential grid axis, so nothing carries between blocks;
//   tiles past the causal frontier or before the window are never
//   loaded).  Per key tile: K and V go to shared memory as float32 (zero
//   past Skv and past D), each thread computes a TR x TC register tile of
//   scores from the scaled, transposed Q tile, the 16 threads that share a
//   row reduce its max with shuffles, and the thread rescales its TR x DC
//   accumulator tile and adds P V, with P staged through the K buffer.
//   Its products run on the float32 CUDA cores (67 TFLOP/s: 4.1 ms at
//   best at the shape above).
//
// Both keep the masked-entry zeroing of the Pallas kernel (p *= mask):
// with the -1e30 mask value, a row whose tile holds only masked keys for
// it would otherwise add exp(0) = 1 per key.  Ragged edges (Sq, Skv not
// multiples of the tiles) are masked, so any lengths are taken; q, k and v
// are read through their batch, head and sequence strides (the head dim
// must be unit-stride), so the model's transposed views need no copy.
//
// Plain C interface: device pointers, shapes, strides (in elements for the
// CUDA-core route; the tensor-map dims, byte strides and boxes for the
// tensor-core route), the mask flags and the CUDA stream; each function
// returns the launch's cudaError_t (0 on success), or for the tensor-core
// route a negative code when a tensor map cannot be made.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kColGroups = 16;                       // threads sharing a row
constexpr int kRowGroups = kThreads / kColGroups;    // 8
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;  // strides (elements) of batch, head, sequence
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int hq, hkv, sq, skv, d;
  int causal, has_window, window;
  float scale;
};

template <int DP, int BQ, int BK>
struct Shape {
  static constexpr int TR = BQ / kRowGroups;   // query rows per thread
  static constexpr int TC = BK / kColGroups;   // key columns per thread
  static constexpr int DC = DP / kColGroups;   // output columns per thread
  static constexpr int KS = DP + 4;            // row stride of the K, V tiles
  static constexpr int PS = BQ + 4;            // row stride of P^T
  static constexpr int KBUF = BK * (KS > PS ? KS : PS);  // K, then P^T
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(DP) * BQ + KBUF + BK * KS);
  static_assert(BQ % (4 * kRowGroups) == 0, "TR must be a multiple of 4");
  static_assert(BK % kColGroups == 0 && DP % kColGroups == 0, "tiles");
  static_assert(DP % 4 == 0, "float4 rows");
};

template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 2) fa_forward(Args a) {
  using S = Shape<DP, BQ, BK>;
  constexpr int TR = S::TR, TC = S::TC, DC = S::DC, KS = S::KS, PS = S::PS;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // [DP][BQ]: q * scale, transposed
  float* sK = sQ + DP * BQ;          // [BK][KS]: keys; then P^T [BK][PS]
  float* sV = sK + S::KBUF;          // [BK][KS]: values

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups;
  const int cg = tid % kColGroups;
  const int bh = blockIdx.x;
  const int b = bh / a.hq;
  const int h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  // the longest causal tiles first: blockIdx.y counts down the query tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int off = a.skv - a.sq;
  const int d = a.d;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int idx = tid; idx < BQ * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    float x = 0.0f;
    if (q0 + r < a.sq && c < d) {
      x = to_f32(qp[static_cast<int64_t>(q0 + r) * a.q_ss + c]) * a.scale;
    }
    sQ[c * BQ + r] = x;
  }

  // key tiles that hold a visible key for some row of this query tile
  const int p_first = q0 + off;
  const int p_last = min(q0 + BQ, a.sq) - 1 + off;
  const int n_tiles = (a.skv + BK - 1) / BK;
  int kt_lo = 0;
  int kt_hi = n_tiles;
  if (a.causal) kt_hi = p_last < 0 ? 0 : min(n_tiles, p_last / BK + 1);
  if (a.has_window) {
    const int64_t lo = static_cast<int64_t>(p_first) - a.window + 1;
    if (lo > 0) {
      const int64_t t = lo / BK;
      kt_lo = t < n_tiles ? static_cast<int>(t) : n_tiles;
    }
  }

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's P^T and V are read
    for (int idx = tid; idx < BK * DP; idx += kThreads) {
      const int j = idx / DP;
      const int c = idx - j * DP;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + j < a.skv && c < d) {
        kx = to_f32(kp[static_cast<int64_t>(k0 + j) * a.k_ss + c]);
        vx = to_f32(vp[static_cast<int64_t>(k0 + j) * a.v_ss + c]);
      }
      sK[j * KS + c] = kx;
      sV[j * KS + c] = vx;
    }
    __syncthreads();

    // scores of rows rg*TR + i against keys k0 + cg + 16 c
    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int dd = 0; dd < DP; dd += 4) {
      float kv[TC][4];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(
            sK + (cg + kColGroups * c) * KS + dd);
        kv[c][0] = x.x;
        kv[c][1] = x.y;
        kv[c][2] = x.z;
        kv[c][3] = x.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float qv[TR];
#pragma unroll
        for (int u = 0; u < TR; u += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              sQ + (dd + e) * BQ + rg * TR + u);
          qv[u] = x.x;
          qv[u + 1] = x.y;
          qv[u + 2] = x.z;
          qv[u + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c) s[i][c] = fmaf(qv[i], kv[c][e], s[i][c]);
      }
    }

    // mask, online softmax; p replaces s
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int pos = q0 + rg * TR + i + off;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int key = k0 + cg + kColGroups * c;
        const bool vis = key < a.skv && (!a.causal || key <= pos) &&
                         (!a.has_window || key > pos - a.window);
        s[i][c] = vis ? s[i][c] : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = kColGroups / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int key = k0 + cg + kColGroups * c;
        const bool vis = key < a.skv && (!a.causal || key <= pos) &&
                         (!a.has_window || key > pos - a.window);
        const float p = vis ? expf(s[i][c] - m_new) : 0.0f;
        s[i][c] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + psum;  // this thread's share of the row's sum
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with the keys
    float* sP = sK;   // P^T [BK][PS]; the padded stride spreads the banks
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c)
        sP[(cg + kColGroups * c) * PS + rg * TR + i] = s[i][c];
    __syncthreads();

    const int jn = min(BK, a.skv - k0);
    for (int j = 0; j < jn; ++j) {
      float pv[TR];
#pragma unroll
      for (int u = 0; u < TR; u += 4) {
        const float4 x =
            *reinterpret_cast<const float4*>(sP + j * PS + rg * TR + u);
        pv[u] = x.x;
        pv[u + 1] = x.y;
        pv[u + 2] = x.z;
        pv[u + 3] = x.w;
      }
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[j * KS + cg + kColGroups * c];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* op = static_cast<T*>(a.o) + (static_cast<int64_t>(bh) * a.sq) * d;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float lsum = l[i];
#pragma unroll
    for (int o = kColGroups / 2; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(kFull, lsum, o);
    const float safe = lsum > 0.0f ? lsum : 1.0f;
    const int row = q0 + rg * TR + i;
    if (row < a.sq) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = cg + kColGroups * c;
        if (col < d) {
          op[static_cast<int64_t>(row) * d + col] = from_f32<T>(acc[i][c] / safe);
        }
      }
    }
  }
}

template <typename T, int DP, int BQ, int BK>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  using S = Shape<DP, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward<T, DP, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.hq, (a.sq + BQ - 1) / BQ);
  fa_forward<T, DP, BQ, BK><<<grid, kThreads, S::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// The head dim is padded (with zeros in shared memory) to 32, 64, 128 or
// 256; 256 takes smaller tiles so that two blocks still fit an SM.
template <typename T>
cudaError_t dispatch(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32, 64, 64>(a, batch, stream);
  if (a.d <= 64) return launch<T, 64, 64, 64>(a, batch, stream);
  if (a.d <= 128) return launch<T, 128, 64, 64>(a, batch, stream);
  if (a.d <= 256) return launch<T, 256, 32, 32>(a, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  Strides are in
// elements; the head dim is unit-stride; out is contiguous (B, Hq, Sq, D).
// window is read only when has_window is set.  Returns a cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int batch, int hq, int hkv, int sq, int skv, int d, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int causal, int has_window,
    int window, float scale, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || skv <= 0 ||
      d <= 0 || d > 256 || (sq + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         hq, hkv, sq, skv, d,
         causal, has_window, window, scale};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(a, batch, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(a, batch, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// The tensor-core route
// ---------------------------------------------------------------------------

namespace {

constexpr int kTcBQ = 128;          // query rows per block, 64 per consumer
constexpr int kTcThreads = 384;     // producer + 2 consumer warpgroups
constexpr int kTcStages = 2;        // depth of the K ring and of the V ring
constexpr int kConsumerWarps = 8;   // arrivals on an empty barrier
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536, "registers");

struct TcArgs {
  void* o;
  int hq, hkv, sq, skv, d;
  int causal, has_window, window;
  float scale_log2;  // scale * log2(e): scores go to exp2
};

// DP: D padded to a multiple of 64 (one 128-byte swizzle atom of bf16 per
// 64 columns; TMA fills the columns past D with zeros).  BK: keys a tile.
template <int DP, int BK>
struct TcShape {
  static constexpr int kChunks = DP / 64;
  static constexpr int kQChunk = kTcBQ * 128;   // bytes of one Q column chunk
  static constexpr int kKVChunk = BK * 128;     // ... of one K or V chunk
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;   // one K or V tile
  // Q, then the K ring, then the V ring
  static constexpr int kTileBytes = kQBytes + 2 * kTcStages * kKVBytes;
  // 1,024 bytes of slack to align the tiles for the swizzle, then the
  // barriers: full and empty for each K and V stage, and Q's
  static constexpr size_t kSmem = 1024 + kTileBytes + 8 * (4 * kTcStages + 1);
  static_assert(kSmem <= 232448, "shared memory");
  static_assert(BK % 16 == 0 && BK <= 256 && DP <= 256, "wgmma shapes");
};

// S (64 x BK) = Q (64 x 16 k-steps) K^T over the padded head dim.  dq, dk:
// descriptors of the warpgroup's Q rows and of the K stage; a k16 step
// moves 32 bytes along the 128-byte row, then on to the next 64 columns.
template <int DP, int BK>
__device__ __forceinline__ void qk_product(float (&s)[BK / 2], uint64_t dq,
                                           uint64_t dk) {
  using S = TcShape<DP, BK>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t da = dq + (((kk / 4) * S::kQChunk + (kk % 4) * 32) >> 4);
    const uint64_t db = dk + (((kk / 4) * S::kKVChunk + (kk % 4) * 32) >> 4);
    if constexpr (BK == 128) {
      sm90::wgmma_ss_n128(s, da, db, kk > 0);
    } else {
      sm90::wgmma_ss_n64(s, da, db, kk > 0);
    }
  }
}

// O (64 x DP) += P (64 x BK, bf16 pairs in registers) V (BK x DP).  The
// pairs of keys 16t .. 16t + 15 are p[4t .. 4t + 3]; dv: the V stage's
// descriptor, 16 keys (2,048 bytes) a step.
template <int DP, int BK>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&p)[BK / 4],
                                           uint64_t dv) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) {
    const uint32_t a[4] = {p[4 * t], p[4 * t + 1], p[4 * t + 2], p[4 * t + 3]};
    const uint64_t db = dv + ((t * 16 * 128) >> 4);
    if constexpr (DP == 64) {
      sm90::wgmma_rs_n64(o, a, db);
    } else if constexpr (DP == 128) {
      sm90::wgmma_rs_n128(o, a, db);
    } else {
      sm90::wgmma_rs_n256(o, a, db);
    }
  }
}

// Where a consumer thread's accumulator entries sit: entry e is at row
// row0 + 8 ((e >> 1) & 1) and column 8 (e >> 2) + col0 + (e & 1) of the
// warpgroup's 64-row tile (the wgmma accumulator layout).
struct Frag {
  int pos0;        // key-stream position of the thread's first row
  int col0;        // its first column
  int wpos_first;  // positions of the warpgroup's first and last rows
  int wpos_last;
};

// 2^x in one MUFU instruction.  exp2f wraps it in three more to keep
// results below 2^-126, which this flushes to 0: such a p is far below the
// last bit of its row's l (>= 1, the row's max key gives p = 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile of the online softmax, in place: scores s of keys k0 .. k0 +
// BK - 1 become p = exp2(s * scale log2 e - m) (0 where masked); m and
// this thread's share of l move on; alpha = exp2(m_old - m_new) per row.
// kMasked: the tile straddles Skv, the causal frontier or the window's
// lower edge for some row of this warpgroup, so each entry is checked.
template <int BK, bool kMasked>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               const TcArgs& a, const Frag& f,
                                               int k0) {
  auto visible = [&](int e) {
    const int key = k0 + 8 * (e >> 2) + f.col0 + (e & 1);
    const int pos = f.pos0 + 8 * ((e >> 1) & 1);
    return key < a.skv && (!a.causal || key <= pos) &&
           (!a.has_window || key > pos - a.window);
  };
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    float x = s[e] * a.scale_log2;
    if (kMasked && !visible(e)) x = kNegInf;
    s[e] = x;
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
  float psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    float p = ex2(s[e] - m[(e >> 1) & 1]);
    // the masked entries (a visible score reaches -1e30 only for inputs
    // near bf16's range)
    if (kMasked && s[e] == kNegInf) p = 0.0f;
    s[e] = p;
    psum[(e >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
}

template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const TcArgs& a, const Frag& f,
                                             int k0) {
  const bool masked = k0 + BK > a.skv ||
                      (a.causal && k0 + BK - 1 > f.wpos_first) ||
                      (a.has_window && k0 < f.wpos_last - a.window + 1);
  if (masked) {
    online_softmax<BK, true>(s, m, l, alpha, a, f, k0);
  } else {
    online_softmax<BK, false>(s, m, l, alpha, a, f, k0);
  }
}

// P (float32) to the bf16 A fragments of the P V product: entries 8t ..
// 8t + 7 (keys 16t .. 16t + 15) are exactly a 64 x 16 tile's A fragment.
template <int BK>
__device__ __forceinline__ void to_bf16(uint32_t (&p)[BK / 4],
                                        const float (&s)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) p[i] = sm90::pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int DP, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
    fa_forward_tc(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, TcArgs a) {
  using S = TcShape<DP, BK>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = tiles;
  uint8_t* sK = tiles + S::kQBytes;               // stage s at s * kKVBytes
  uint8_t* sV = sK + kTcStages * S::kKVBytes;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(tiles + S::kTileBytes);
  uint64_t* full_v = full_k + kTcStages;
  uint64_t* empty_k = full_v + kTcStages;
  uint64_t* empty_v = empty_k + kTcStages;
  uint64_t* qbar = empty_v + kTcStages;

  const int bh = blockIdx.x;
  const int b = bh / a.hq;
  const int h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  // the longest causal tiles first: blockIdx.y counts down the query tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;
  const int off = a.skv - a.sq;

  // key tiles that hold a visible key for some row of this query tile
  const int p_first = q0 + off;
  const int p_last = min(q0 + kTcBQ, a.sq) - 1 + off;
  const int n_tiles = (a.skv + BK - 1) / BK;
  int kt_lo = 0;
  int kt_hi = n_tiles;
  if (a.causal) kt_hi = p_last < 0 ? 0 : min(n_tiles, p_last / BK + 1);
  if (a.has_window) {
    const int64_t lo = static_cast<int64_t>(p_first) - a.window + 1;
    if (lo > 0) {
      const int64_t t = lo / BK;
      kt_lo = t < n_tiles ? static_cast<int>(t) : n_tiles;
    }
  }
  const int n = kt_hi > kt_lo ? kt_hi - kt_lo : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty_k[s], kConsumerWarps);
      sm90::mbar_init(&empty_v[s], kConsumerWarps);
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // warp-uniform by construction, so that ptxas sees whole warpgroups take
  // each side of the branch (setmaxnreg needs it)
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----------------------
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n > 0) {
      sm90::mbar_arrive_expect_tx(qbar, S::kQBytes);
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c)
        sm90::tma_load_4d(sQ + c * S::kQChunk, &tq, qbar, c * 64, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kTcStages;
        // the first pass over each ring finds every stage free
        const uint32_t free_parity = ((i / kTcStages) & 1) ^ 1;
        const int k0 = (kt_lo + i) * BK;
        sm90::mbar_wait(&empty_k[s], free_parity);
        sm90::mbar_arrive_expect_tx(&full_k[s], S::kKVBytes);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c)
          sm90::tma_load_4d(sK + s * S::kKVBytes + c * S::kKVChunk, &tk,
                            &full_k[s], c * 64, k0, hk, b);
        sm90::mbar_wait(&empty_v[s], free_parity);
        sm90::mbar_arrive_expect_tx(&full_v[s], S::kKVBytes);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c)
          sm90::tma_load_4d(sV + s * S::kKVBytes + c * S::kKVChunk, &tv,
                            &full_v[s], c * 64, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------------
    // Tile j's softmax runs while the tensor cores do tile j-1's P V:
    //   issue S_j = Q K_j^T and O += P_{j-1} V_{j-1}; wait for S_j (K_j
    //   free); softmax of S_j; wait for the P V (V_{j-1} free); O *= alpha_j;
    //   P_j to bf16.
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x - 128 * wg;  // thread within the warpgroup
    const int lane = t % 32;
    const int wrow = (wg - 1) * 64;
    const int row0 = wrow + (t / 32) * 16 + lane / 4;
    const Frag f{q0 + row0 + off, (lane % 4) * 2, q0 + wrow + off, q0 + wrow + off + 63};
    // K-major Q and K tiles; MN-major V with 64 columns every kKVChunk
    const uint64_t dq = sm90::sw128_desc(sm90::smem_u32(sQ) + wrow * 128, 16, 1024);
    const uint32_t k_addr = sm90::smem_u32(sK);
    const uint32_t v_addr = sm90::smem_u32(sV);
    auto k_desc = [&](int s) {
      return sm90::sw128_desc(k_addr + s * S::kKVBytes, 16, 1024);
    };
    auto v_desc = [&](int s) {
      return sm90::sw128_desc(v_addr + s * S::kKVBytes, S::kKVChunk, 1024);
    };

    float o[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o[e] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};  // this thread's share of its rows' sums
    float alpha[2];
    float sc[BK / 2];
    uint32_t p[BK / 4];

    if (n > 0) {
      sm90::mbar_wait(qbar, 0);
      sm90::mbar_wait(&full_k[0], 0);
      sm90::wgmma_fence();
      qk_product<DP, BK>(sc, dq, k_desc(0));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty_k[0]);
      softmax_tile<BK>(sc, m, l, alpha, a, f, kt_lo * BK);
      to_bf16<BK>(p, sc);
    }
    for (int j = 1; j < n; ++j) {
      const int s = j % kTcStages;
      const int sp = (j - 1) % kTcStages;
      sm90::mbar_wait(&full_k[s], (j / kTcStages) & 1);
      sm90::mbar_wait(&full_v[sp], ((j - 1) / kTcStages) & 1);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      qk_product<DP, BK>(sc, dq, k_desc(s));
      sm90::wgmma_commit();
      pv_product<DP, BK>(o, p, v_desc(sp));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S_j is in; the P V may still run
      sm90::fence_regs(sc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty_k[s]);
      softmax_tile<BK>(sc, m, l, alpha, a, f, (kt_lo + j) * BK);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty_v[sp]);
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      to_bf16<BK>(p, sc);
    }
    if (n > 0) {
      const int sp = (n - 1) % kTcStages;
      sm90::mbar_wait(&full_v[sp], ((n - 1) / kTcStages) & 1);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      pv_product<DP, BK>(o, p, v_desc(sp));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    }

    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) +
                        static_cast<int64_t>(bh) * a.sq * a.d;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lsum = l[r];
      lsum += __shfl_xor_sync(kFull, lsum, 1);
      lsum += __shfl_xor_sync(kFull, lsum, 2);
      const float safe = lsum > 0.0f ? lsum : 1.0f;
      const int row = q0 + row0 + 8 * r;
      if (row < a.sq) {
        __nv_bfloat16* orow = op + static_cast<int64_t>(row) * a.d;
#pragma unroll
        for (int jj = 0; jj < DP / 8; ++jj) {
          const int col = 8 * jj + f.col0;
          if (col < a.d) {
            const __nv_bfloat162 pair = __floats2bfloat162_rn(
                o[4 * jj + 2 * r] / safe, o[4 * jj + 2 * r + 1] / safe);
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = pair;
          }
        }
      }
    }
  }
}

template <int DP, int BK>
cudaError_t launch_tc(const CUtensorMap& mq, const CUtensorMap& mk,
                      const CUtensorMap& mv, const TcArgs& a, int batch,
                      cudaStream_t stream) {
  using S = TcShape<DP, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward_tc<DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.hq, (a.sq + kTcBQ - 1) / kTcBQ);
  fa_forward_tc<DP, BK><<<grid, kTcThreads, S::kSmem, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the runtime already loaded,
// so the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map {D, S, H, B} with the 128-byte swizzle; zeros out of range.
int encode(CUtensorMap* map, const void* base, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

}  // namespace

// The tensor-core route (bfloat16 only).  dims: {D, S, H, B} of q, k, v (3 x
// 4); strides: byte strides of S, H, B of q, k, v (3 x 3); boxes: {64, rows,
// 1, 1} of q, k, v (3 x 4), rows = 128 for q and bk for k, v.  dp, bk: the
// tile shape (64, 128), (128, 128) or (256, 64).  window is read only when
// has_window is set.  Returns a cudaError_t, -1 when the driver has no
// cuTensorMapEncodeTiled, or -1000 - CUresult when a map is refused.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* out,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* boxes,
    int batch, int hq, int hkv, int sq, int skv, int d, int dp, int bk,
    int causal, int has_window, int window, float scale, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || skv <= 0 ||
      d <= 0 || d % 8 || d > dp || (sq + kTcBQ - 1) / kTcBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i) {
    const cuuint32_t rows = i == 0 ? kTcBQ : bk;
    if (boxes[4 * i] != 64 || boxes[4 * i + 1] != rows || boxes[4 * i + 2] != 1 ||
        boxes[4 * i + 3] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int r = encode(&maps[i], bases[i], dims + 4 * i, strides + 3 * i, boxes + 4 * i);
    if (r != 0) return r;
  }
  TcArgs a{out, hq, hkv, sq, skv, d, causal, has_window, window, scale * kLog2e};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dp == 64 && bk == 128)
    err = launch_tc<64, 128>(maps[0], maps[1], maps[2], a, batch, st);
  else if (dp == 128 && bk == 128)
    err = launch_tc<128, 128>(maps[0], maps[1], maps[2], a, batch, st);
  else if (dp == 256 && bk == 64)
    err = launch_tc<256, 64>(maps[0], maps[1], maps[2], a, batch, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
