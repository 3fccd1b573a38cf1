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
// and output; this first version does them on the float32 CUDA cores
// (67 TFLOP/s, so 4.1 ms at best), not on the tensor cores.
//
// Design: one block of 128 threads per (batch x query head, tile of BQ
// queries); it loops over the key tiles of BK keys that hold a visible key
// for some row of the tile (the loop takes the place of the TPU's
// sequential grid axis, so nothing carries between blocks; tiles past the
// causal frontier or before the window are never loaded).  Per key tile:
// K and V go to shared memory as float32 (zero past Skv and past D), each
// thread computes a TR x TC register tile of scores from the scaled,
// transposed Q tile, the 16 threads that share a row reduce its max with
// shuffles, and the thread rescales its TR x DC accumulator tile and adds
// P V, with P staged through the K buffer.  The masked-entry zeroing of the
// Pallas kernel (p *= mask) is kept: with the -1e30 mask value, a row whose
// tile holds only masked keys for it would otherwise add exp(0) = 1 per key.
// Ragged edges (Sq, Skv not multiples of the tiles) are masked here, so any
// lengths are taken; q, k and v are read through their batch, head and
// sequence strides (the head dim must be unit-stride), so the model's
// transposed views need no copy.
//
// Plain C interface: device pointers, shapes, strides (in elements), the
// mask flags and the CUDA stream; the function returns the launch's
// cudaError_t (0 on success).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
