// flash_attention_bwd: the gradient of flash_attention's tensor-core route
// (bfloat16; causal and/or sliding window, GQA/MQA, any Sq and Skv, D a
// multiple of 8 up to 256), for sm_90a.
//
// Replaces the gradient that jax.grad takes of the chunked XLA path of
// src/repro/kernels/flash_attention/ref.py, through which the reference
// trains: its Pallas kernel (src/repro/kernels/flash_attention/kernel.py:97)
// has no backward.  The port's plain version is `flash_attention_bwd`
// (kernels/flash_attention/grad.py, float32 PyTorch ops); this computes the
// same function:
//
//   S = (q . k) scale; P = exp(S - lse) on the visible entries (0 elsewhere),
//   lse the forward's row log-sum-exp (natural log; fa_forward_tc writes it,
//   +inf for a row that sees no key, whose P is then 0);
//   D = rowsum(dO * O) from the forward's bf16 O;
//   dV = P^T dO, dP = dO V^T, dS = P (dP - D), dQ = scale dS K,
//   dK = scale dS^T Q; the masks are the forward's (off = Skv - Sq, causal,
//   window), and for GQA dK and dV sum over the G query heads of a KV head.
//
// Bound on an H100: operations.  Five products of 2 D flops for each
// visible (query, key) pair and query head (S, dP, dV, dQ, dK): at yi-6b's
// training shape (B = 4, Hq = 32, Hkv = 4, S = 2,048, D = 128, causal)
// 3.44e11 flops against 304 MB, 0.348 ms at the bf16 tensor-core peak
// (989 TFLOP/s); the bytes take 0.091 ms at 3.35 TB/s.
//
// What the design does about it: every product is a bf16 wgmma with
// float32 accumulators, fed by TMA (4-D tensor maps over the strided (B,
// H, S, D) views, 128-byte swizzle, zeros past S and past D) through
// mbarrier rings that a producer warpgroup (setmaxnreg.dec) keeps full for
// two consumer warpgroups (setmaxnreg.inc); S, P, dP and dS live in
// registers (and P in shared memory between two warpgroups), never in
// device memory.  P and dS are rounded to bf16 in registers as the A
// operand of the products that read them (the accumulator layout is the A
// fragment layout), Q, dO and K are read MN-major through the transpose
// bit where they are the B operand of such a product.  Masks are computed
// only on tiles that straddle Skv, the causal frontier or the window's
// edge.  Results are deterministic (no atomics, no split sums): the
// wrapper launches three kernels in order, FlashAttention-3's
// deterministic layout:
//
// * `fa_backward_delta`: D = rowsum(dO * O) in float32, one warp a row, and
//   lse * log2 e, both on rows padded to whole 128-row tiles.
// * `fa_backward_dkdv`: one block per (batch x KV head, tile of 64 keys).
//   K and V stay in shared memory; the producer streams (Q, dO) tiles of
//   64 query rows, every query tile of every query head of the group that
//   sees the key tile (grad.py's `row_span`), through a 4-stage ring (2 at
//   D = 256), each step's 64 rows of lse and D with it (a bulk copy on the
//   same barrier).  Key tiles run along the grid's x, so the blocks in
//   flight share their KV heads' Q and dO in L2.
//   Warpgroup 1 computes S^T = K Q^T, P^T = exp2(S^T scale log2 e -
//   lse log2 e), hands P^T (float32) to warpgroup 2 through a double buffer
//   in shared memory (named barriers), and accumulates dV += P^T dO;
//   warpgroup 2 computes dP^T = V dO^T, dS^T = P^T (dP^T - D) and
//   accumulates dK += dS^T Q.  Each warpgroup runs two products a tile and
//   holds one 64 x D accumulator (D = 256 fits: 128 registers each), and
//   dK, dV sum the whole group in registers, so no block adds into
//   another's output.
// * `fa_backward_dq`: one block per (batch x query head, tile of 128
//   queries), two consumer warpgroups of 64 rows as in the forward; Q and
//   dO load once, K and V tiles of 64 keys stream through two rings (3
//   stages, 1 at D = 256, for shared memory); per key tile S = Q K^T and
//   dP = dO V^T, then dS = P (dP - D) and dQ += dS K.
//
// This costs seven products (S and dP in both passes) against the five of
// the bound: the five-product layout sums dQ across key tiles, by atomics,
// whose order (and so the bits) changes from run to run, or through a
// float32 buffer of one dQ per key tile read back in order, which moves
// far more bytes than Q.  Two launches here give the same bits.
//
// Plain C interface: `flash_attention_bwd_launch` launches one of the three
// kernels (the wrapper calls it three times and counts each) and returns its
// cudaError_t (0 on success), -1 when the driver has no
// cuTensorMapEncodeTiled, or -1000 - CUresult when a tensor map is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;   // arrivals on an empty barrier
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeys = 64;           // keys a tile (both passes); query rows a
                                    // tile of the dK/dV pass
constexpr int kDqRows = 128;        // query rows a block of the dQ pass
constexpr int kAtom = 64 * 128;     // bytes of 64 columns of a 64-row tile
constexpr int kXBuf = 64 * 64 * 4;  // one P^T exchange buffer (float32)
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536, "registers");

struct BwdArgs {
  const float* lse2;   // (B, Hq, sq_pad) row log-sum-exp * log2 e, +inf past Sq
  const float* delta;  // (B, Hq, sq_pad) D = rowsum(dO * O), 0 past Sq
  void* g0;            // dq (B, Hq, Sq, D) or dk (B, Hkv, Skv, D), contiguous
  void* g1;            // dv (B, Hkv, Skv, D), contiguous (dK/dV pass)
  int hq, hkv, sq, skv, d, sq_pad;
  int causal, has_window, window;
  float scale;       // the softmax scale
  float scale_log2;  // scale * log2 e: scores go to exp2
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// key `key` visible to query row `q` (position q + Skv - Sq)
__device__ __forceinline__ bool visible(const BwdArgs& a, int key, int q) {
  const int pos = q + a.skv - a.sq;
  return key < a.skv && q < a.sq && (!a.causal || key <= pos) &&
         (!a.has_window || key > pos - a.window);
}

__device__ __forceinline__ int64_t clamp_rows(int64_t r, int sq) {
  return r < 0 ? 0 : (r > sq ? sq : r);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// d (64 x 64) = A (64 x DP) B (64 x DP)^T, both K-major bf16 tiles in
// shared memory; da, db: descriptors of their first rows; a_chunk,
// b_chunk: bytes from one 64-column chunk of the tile to the next.
template <int DP>
__device__ __forceinline__ void ss_product(float (&d)[32], uint64_t da, int a_chunk,
                                           uint64_t db, int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    sm90::wgmma_ss_n64(d, da + (((kk / 4) * a_chunk + (kk % 4) * 32) >> 4),
                       db + (((kk / 4) * b_chunk + (kk % 4) * 32) >> 4), kk > 0);
  }
}

// d (64 x DP) += A (64 x 64, bf16 pairs in registers) B (64 x DP): B a
// 64-row tile read MN-major (db: its descriptor, LBO = kAtom); the pairs of
// columns 16t .. 16t + 15 of A are a[4t .. 4t + 3].
template <int DP>
__device__ __forceinline__ void rs_product(float (&d)[DP / 2], const uint32_t (&a)[16],
                                           uint64_t db) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t f[4] = {a[4 * t], a[4 * t + 1], a[4 * t + 2], a[4 * t + 3]};
    const uint64_t b = db + ((t * 16 * 128) >> 4);
    if constexpr (DP == 64) {
      sm90::wgmma_rs_n64(d, f, b);
    } else if constexpr (DP == 128) {
      sm90::wgmma_rs_n128(d, f, b);
    } else {
      sm90::wgmma_rs_n256(d, f, b);
    }
  }
}

// a 64 x 64 float32 accumulator to the bf16 A fragments of the next product
__device__ __forceinline__ void to_bf16(uint32_t (&f)[16], const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = sm90::pack_bf16(x[2 * i], x[2 * i + 1]);
}

// Write a consumer's 64 x DP accumulator (rows row0 + 8 r of `rows` valid
// ones starting at `first`) times `mul` as bf16 rows of a contiguous (.., D)
// tensor at `out`.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[DP / 2],
                                           float mul, int first, int row0, int rows,
                                           int col0, int d) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = first + row0 + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* orow = out + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int col = 8 * jj + col0;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * jj + 2 * r] * mul, acc[4 * jj + 2 * r + 1] * mul);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// D = rowsum(dO * O), and lse * log2 e, on rows padded to a multiple of 128
// ---------------------------------------------------------------------------

// One warp a row of the padded (B x Hq, sq_pad) layout; rows past Sq get
// D = 0 and lse * log2 e = +inf (their P is 0), so that the product kernels
// read whole 64- or 128-row tiles of both without a bounds check, and the
// dK/dV pass can bring a step's rows to shared memory in one bulk copy.
__global__ void __launch_bounds__(256) fa_backward_delta(
    const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse, float* lse2,
    float* delta, int64_t rows, int hq, int sq, int sq_pad, int d, int64_t do_sb,
    int64_t do_sh, int64_t do_ss) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  const int64_t bh = row / sq_pad;
  const int64_t s = row - bh * sq_pad;
  if (s >= sq) {
    if (lane == 0) {
      delta[row] = 0.0f;
      lse2[row] = pos_inf();
    }
    return;
  }
  const int64_t b = bh / hq;
  const int64_t h = bh - b * hq;
  const __nv_bfloat16* orow = o + (bh * sq + s) * d;
  const __nv_bfloat16* grow = dout + b * do_sb + h * do_sh + s * do_ss;
  float acc = 0.0f;
  for (int c = 2 * lane; c < d; c += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(grow + c));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = lse[bh * sq + s] * kLog2e;
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one block per (batch x KV head, 64 keys)
// ---------------------------------------------------------------------------

template <int DP>
struct DkdvShape {
  static constexpr int kChunks = DP / 64;
  static constexpr int kTile = kChunks * kAtom;  // one 64-row tile
  // depth of the (Q, dO) ring: a step is short, so loads run 3 steps ahead
  // where shared memory allows
  static constexpr int kStages = DP == 256 ? 2 : 4;
  static constexpr int kCols = 2 * 64 * 4;       // a step's lse * log2 e and D
  // K, V, the Q ring, the dO ring, two P^T buffers, the (lse, D) ring
  static constexpr int kTileBytes =
      2 * kTile + 2 * kStages * kTile + 2 * kXBuf + kStages * kCols;
  // 1,024 bytes of slack to align the tiles, then the barriers: full and
  // empty for each stage, and K/V's
  static constexpr size_t kSmem = 1024 + kTileBytes + 8 * (2 * kStages + 1);
  static_assert(kSmem <= 232448, "shared memory");
};

// named barriers of the P^T hand-over: buffer x is full (warpgroup 1 wrote
// it) or empty (warpgroup 2 read it)
constexpr int kBarFull = 1;   // ids 1, 2
constexpr int kBarEmpty = 3;  // ids 3, 4

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    fa_backward_dkdv(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, BwdArgs a) {
  using S = DkdvShape<DP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* tiles = align1024(smem_raw);
  uint8_t* sK = tiles;
  uint8_t* sV = sK + S::kTile;
  uint8_t* sQ = sV + S::kTile;                 // stage s at s * kTile
  uint8_t* sdO = sQ + S::kStages * S::kTile;
  float4* xbuf = reinterpret_cast<float4*>(sdO + S::kStages * S::kTile);
  // stage s: 64 lse * log2 e, then 64 D, at s * 128
  float* scols = reinterpret_cast<float*>(sdO + S::kStages * S::kTile + 2 * kXBuf);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + S::kTileBytes);
  uint64_t* empty = full + S::kStages;
  uint64_t* kvbar = empty + S::kStages;

  // key tiles along x, so that the blocks in flight share a few KV heads'
  // (Q, dO) in L2; the first (longest causal) tiles of each first
  const int bh = blockIdx.y;  // batch x KV head
  const int b = bh / a.hkv;
  const int hk = bh % a.hkv;
  const int g = a.hq / a.hkv;
  const int k0 = blockIdx.x * kKeys;
  const int k1 = min(k0 + kKeys, a.skv);
  const int off = a.skv - a.sq;
  // query rows [r0, r1) that see some key of [k0, k1) (grad.py row_span)
  int64_t r0 = 0;
  int64_t r1 = a.sq;
  if (a.causal) r0 = clamp_rows(static_cast<int64_t>(k0) - off, a.sq);
  if (a.has_window)
    r1 = clamp_rows(static_cast<int64_t>(k1) - 1 + a.window - off, a.sq);
  const int qt_lo = static_cast<int>(r0 / kKeys);
  const int nq = r1 > r0 ? static_cast<int>((r1 + kKeys - 1) / kKeys) - qt_lo : 0;
  const int n = nq * g;  // (head, query tile) steps

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::mbar_init(kvbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every load ----------------------------
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n > 0) {
      sm90::mbar_arrive_expect_tx(kvbar, 2 * S::kTile);
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) {
        sm90::tma_load_4d(sK + c * kAtom, &tk, kvbar, c * 64, k0, hk, b);
        sm90::tma_load_4d(sV + c * kAtom, &tv, kvbar, c * 64, k0, hk, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % S::kStages;
        const int h = hk * g + i / nq;
        const int q0 = (qt_lo + i % nq) * kKeys;
        const int64_t row = (static_cast<int64_t>(b) * a.hq + h) * a.sq_pad + q0;
        sm90::mbar_wait(&empty[s], ((i / S::kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * S::kTile + S::kCols);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c) {
          sm90::tma_load_4d(sQ + s * S::kTile + c * kAtom, &tq, &full[s], c * 64, q0, h, b);
          sm90::tma_load_4d(sdO + s * S::kTile + c * kAtom, &tdo, &full[s], c * 64, q0, h,
                            b);
        }
        sm90::bulk_load(scols + s * 128, a.lse2 + row, 256, &full[s]);
        sm90::bulk_load(scols + s * 128 + 64, a.delta + row, 256, &full[s]);
      }
    }
    return;
  }

  // ---- consumers: both hold all 64 keys of the tile ------------------------
  // Warpgroup 1: S^T = K Q^T, P^T, hand P^T over, dV += P^T dO.  Warpgroup
  // 2: dP^T = V dO^T, take P^T, dS^T = P^T (dP^T - D), dK += dS^T Q.  Each
  // waits for each of its products (issuing the next step's first product
  // behind the second measured slower on the H100).
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x - 128 * wg;  // thread within the warpgroup
  const int lane = t % 32;
  const int row0 = (t / 32) * 16 + lane / 4;  // the thread's first key row
  const int col0 = (lane % 4) * 2;            // its first query column
  const uint32_t q_addr = sm90::smem_u32(sQ);
  const uint32_t do_addr = sm90::smem_u32(sdO);
  // first product: A = K or V (K-major), B = the stage's Q or dO (K-major);
  // second: B = the stage's dO or Q (MN-major)
  const uint64_t da = sm90::sw128_desc(sm90::smem_u32(wg == 1 ? sK : sV), 16, 1024);
  const uint32_t b1_addr = wg == 1 ? q_addr : do_addr;
  const uint32_t b2_addr = wg == 1 ? do_addr : q_addr;
  const int cols = wg == 1 ? 0 : 64;  // this warpgroup's half of a (lse, D) stage

  float acc[DP / 2];  // dV (warpgroup 1) or dK (warpgroup 2)
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.0f;
  float x[32];     // S^T then P^T, or dP^T then dS^T
  uint32_t f[16];  // x in bf16, the A operand of the second product

  if (n > 0) sm90::mbar_wait(kvbar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % S::kStages;
    const int q0 = (qt_lo + i % nq) * kKeys;
    sm90::mbar_wait(&full[s], (i / S::kStages) & 1);
    sm90::wgmma_fence();
    ss_product<DP>(x, da, kAtom, sm90::sw128_desc(b1_addr + s * S::kTile, 16, 1024), kAtom);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(x);
    // column 8 j + col0 + c of the tile is entry 4 j + c (and 4 j + 2 + c)
    const float* cv = scols + s * 128 + cols + col0;
    const int xb = i & 1;
    float4* xp = xbuf + xb * 1024 + t;  // entries 4 j .. 4 j + 3 at xp[128 j]
    if (wg == 1) {
      // the step straddles Sq, Skv, the causal frontier or the window
      const bool masked = q0 + kKeys > a.sq || k0 + kKeys > a.skv ||
                          (a.causal && k0 + kKeys - 1 > q0 + off) ||
                          (a.has_window && k0 <= q0 + kKeys - 1 + off - a.window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float p = sm90::ex2(fmaf(x[e], a.scale_log2, -cv[8 * (e >> 2) + (e & 1)]));
        if (masked &&
            !visible(a, k0 + row0 + 8 * ((e >> 1) & 1), q0 + 8 * (e >> 2) + col0 + (e & 1)))
          p = 0.0f;
        x[e] = p;
      }
      if (i >= 2) sm90::named_sync(kBarEmpty + xb, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xp[128 * j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      __threadfence_block();
      sm90::named_arrive(kBarFull + xb, 256);
    } else {
      sm90::named_sync(kBarFull + xb, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = xp[128 * j];
        const float d0 = cv[8 * j];
        const float d1 = cv[8 * j + 1];
        x[4 * j] = p.x * (x[4 * j] - d0);
        x[4 * j + 1] = p.y * (x[4 * j + 1] - d1);
        x[4 * j + 2] = p.z * (x[4 * j + 2] - d0);
        x[4 * j + 3] = p.w * (x[4 * j + 3] - d1);
      }
      // warpgroup 1 rewrites this buffer two steps on
      if (i + 2 < n) sm90::named_arrive(kBarEmpty + xb, 256);
    }
    to_bf16(f, x);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    // dV += P^T dO, or dK += dS^T Q
    rs_product<DP>(acc, f, sm90::sw128_desc(b2_addr + s * S::kTile, kAtom, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // a tile that no query sees has zero gradients
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(wg == 1 ? a.g1 : a.g0) +
                       static_cast<int64_t>(bh) * a.skv * a.d;
  store_rows<DP>(out, acc, wg == 1 ? 1.0f : a.scale, k0, row0, a.skv, col0, a.d);
}

// ---------------------------------------------------------------------------
// dQ: one block per (batch x query head, 128 queries)
// ---------------------------------------------------------------------------

template <int DP>
struct DqShape {
  static constexpr int kChunks = DP / 64;
  static constexpr int kQChunk = kDqRows * 128;  // bytes of one Q column chunk
  static constexpr int kQTile = kChunks * kQChunk;
  static constexpr int kKVTile = kChunks * kAtom;
  static constexpr int kStages = DP == 256 ? 1 : 3;  // of the K ring and the V ring
  // Q, dO, then the K ring, then the V ring
  static constexpr int kTileBytes = 2 * kQTile + 2 * kStages * kKVTile;
  static constexpr size_t kSmem = 1024 + kTileBytes + 8 * (4 * kStages + 1);
  static_assert(kSmem <= 232448, "shared memory");
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    fa_backward_dq(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, BwdArgs a) {
  using S = DqShape<DP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* tiles = align1024(smem_raw);
  uint8_t* sQ = tiles;
  uint8_t* sdO = sQ + S::kQTile;
  uint8_t* sK = sdO + S::kQTile;               // stage s at s * kKVTile
  uint8_t* sV = sK + S::kStages * S::kKVTile;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(tiles + S::kTileBytes);
  uint64_t* full_v = full_k + S::kStages;
  uint64_t* empty_k = full_v + S::kStages;
  uint64_t* empty_v = empty_k + S::kStages;
  uint64_t* qbar = empty_v + S::kStages;

  const int bh = blockIdx.x;  // batch x query head
  const int b = bh / a.hq;
  const int h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  // the longest causal tiles first: blockIdx.y counts down the query tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  const int off = a.skv - a.sq;

  // key tiles that hold a visible key for some row of this query tile
  const int p_first = q0 + off;
  const int p_last = min(q0 + kDqRows, a.sq) - 1 + off;
  const int n_tiles = (a.skv + kKeys - 1) / kKeys;
  int kt_lo = 0;
  int kt_hi = n_tiles;
  if (a.causal) kt_hi = p_last < 0 ? 0 : min(n_tiles, p_last / kKeys + 1);
  if (a.has_window) {
    const int64_t lo = static_cast<int64_t>(p_first) - a.window + 1;
    if (lo > 0) {
      const int64_t tl = lo / kKeys;
      kt_lo = tl < n_tiles ? static_cast<int>(tl) : n_tiles;
    }
  }
  const int n = kt_hi > kt_lo ? kt_hi - kt_lo : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty_k[s], kConsumerWarps);
      sm90::mbar_init(&empty_v[s], kConsumerWarps);
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer ----------------------------------------------------------
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n > 0) {
      sm90::mbar_arrive_expect_tx(qbar, 2 * S::kQTile);
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) {
        sm90::tma_load_4d(sQ + c * S::kQChunk, &tq, qbar, c * 64, q0, h, b);
        sm90::tma_load_4d(sdO + c * S::kQChunk, &tdo, qbar, c * 64, q0, h, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % S::kStages;
        const uint32_t free_parity = ((i / S::kStages) & 1) ^ 1;
        const int k0 = (kt_lo + i) * kKeys;
        sm90::mbar_wait(&empty_k[s], free_parity);
        sm90::mbar_arrive_expect_tx(&full_k[s], S::kKVTile);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c)
          sm90::tma_load_4d(sK + s * S::kKVTile + c * kAtom, &tk, &full_k[s], c * 64, k0,
                            hk, b);
        sm90::mbar_wait(&empty_v[s], free_parity);
        sm90::mbar_arrive_expect_tx(&full_v[s], S::kKVTile);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c)
          sm90::tma_load_4d(sV + s * S::kKVTile + c * kAtom, &tv, &full_v[s], c * 64, k0,
                            hk, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each --------------------------------------
  // Step j: S = Q K_j^T and dP = dO V_j^T, dS = P (dP - D), dQ += dS K_j.
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x - 128 * wg;
  const int lane = t % 32;
  const int wrow = (wg - 1) * 64;
  const int row0 = wrow + (t / 32) * 16 + lane / 4;  // rows row0, row0 + 8
  const int col0 = (lane % 4) * 2;
  const int wpos_first = q0 + wrow + off;  // the warpgroup's first and last positions
  const int wpos_last = wpos_first + 63;
  const uint64_t dq_a = sm90::sw128_desc(sm90::smem_u32(sQ) + wrow * 128, 16, 1024);
  const uint64_t ddo_a = sm90::sw128_desc(sm90::smem_u32(sdO) + wrow * 128, 16, 1024);
  const uint32_t k_addr = sm90::smem_u32(sK);
  const uint32_t v_addr = sm90::smem_u32(sV);

  float lse2[2], dl[2];  // lse * log2 e and D of rows row0, row0 + 8 (padded rows)
  const int64_t rows = static_cast<int64_t>(bh) * a.sq_pad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = a.lse2[rows + q0 + row0 + 8 * r];
    dl[r] = a.delta[rows + q0 + row0 + 8 * r];
  }

  float acc[DP / 2];  // dQ / scale
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.0f;
  float sc[32], dp[32];
  uint32_t f[16];

  if (n > 0) sm90::mbar_wait(qbar, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % S::kStages;
    const uint32_t parity = (j / S::kStages) & 1;
    const int k0 = (kt_lo + j) * kKeys;
    sm90::mbar_wait(&full_k[s], parity);
    sm90::mbar_wait(&full_v[s], parity);
    sm90::wgmma_fence();
    ss_product<DP>(sc, dq_a, S::kQChunk,
                   sm90::sw128_desc(k_addr + s * S::kKVTile, 16, 1024), kAtom);
    ss_product<DP>(dp, ddo_a, S::kQChunk,
                   sm90::sw128_desc(v_addr + s * S::kKVTile, 16, 1024), kAtom);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty_v[s]);
    const bool masked = k0 + kKeys > a.skv ||
                        (a.causal && k0 + kKeys - 1 > wpos_first) ||
                        (a.has_window && k0 < wpos_last - a.window + 1);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      float p = sm90::ex2(fmaf(sc[e], a.scale_log2, -lse2[r]));
      if (masked && !visible(a, k0 + 8 * (e >> 2) + col0 + (e & 1), q0 + row0 + 8 * r))
        p = 0.0f;
      dp[e] = p * (dp[e] - dl[r]);  // dS
    }
    to_bf16(f, dp);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    // dQ += dS K (K MN-major)
    rs_product<DP>(acc, f, sm90::sw128_desc(k_addr + s * S::kKVTile, kAtom, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty_k[s]);
  }

  // rows that see no key have a zero gradient
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.g0) + static_cast<int64_t>(bh) * a.sq * a.d;
  store_rows<DP>(out, acc, a.scale, q0, row0, a.sq, col0, a.d);
}

template <int DP>
cudaError_t launch_dkdv(const CUtensorMap (&m)[4], const BwdArgs& a, int batch,
                        cudaStream_t stream) {
  constexpr size_t smem = DkdvShape<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      fa_backward_dkdv<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + kKeys - 1) / kKeys, batch * a.hkv);
  fa_backward_dkdv<DP><<<grid, kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const CUtensorMap (&m)[4], const BwdArgs& a, int batch,
                      cudaStream_t stream) {
  constexpr size_t smem = DqShape<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      fa_backward_dq<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.hq, (a.sq + kDqRows - 1) / kDqRows);
  fa_backward_dq<DP><<<grid, kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

}  // namespace

// Launch one kernel of the backward: kernel 0 = fa_backward_delta (reads o,
// dout and lse; writes lse2 and delta), 1 = fa_backward_dkdv (writes dk,
// dv), 2 = fa_backward_dq (writes dq); 1 and 2 read q, k, v, dout, lse2 and
// delta.  All bf16 but lse (float32 (B, Hq, Sq), the forward's natural-log
// row log-sum-exp) and lse2, delta (float32 (B, Hq, sq_pad), sq_pad = Sq
// rounded up to 128: lse * log2 e and D = rowsum(dO * O)); o, dq, dk, dv
// are contiguous (B, H, S, D).  dims: {D, S, H, B} of q, k, v, dout (4 x 4);
// strides: byte strides of S, H, B of q, k, v, dout (4 x 3).  window is read
// only when has_window is set.  Returns a cudaError_t, -1 when the driver has
// no cuTensorMapEncodeTiled, or -1000 - CUresult when a map is refused.
extern "C" int flash_attention_bwd_launch(
    int kernel, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* lse2, float* delta, void* dq, void* dk,
    void* dv, const cuuint64_t* dims, const cuuint64_t* strides, int batch, int hq,
    int hkv, int sq, int skv, int d, int causal, int has_window, int window, float scale,
    void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || skv <= 0 ||
      d <= 0 || d % 8 || d > 256 || (sq + kDqRows - 1) / kDqRows > 65535 ||
      static_cast<int64_t>(batch) * hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sq_pad = (sq + kDqRows - 1) / kDqRows * kDqRows;
  auto st = static_cast<cudaStream_t>(stream);
  if (kernel == 0) {
    const int64_t rows = static_cast<int64_t>(batch) * hq * sq_pad;
    const int64_t blocks = (rows + 7) / 8;
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    // dout's element strides of B, H, S (bf16: 2 bytes)
    fa_backward_delta<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse,
        lse2, delta, rows, hq, sq, sq_pad, d, static_cast<int64_t>(strides[11] / 2),
        static_cast<int64_t>(strides[10] / 2), static_cast<int64_t>(strides[9] / 2));
    return static_cast<int>(cudaGetLastError());
  }
  if (kernel != 1 && kernel != 2) return static_cast<int>(cudaErrorInvalidValue);
  // boxes: 64 columns by 64 rows, but 128 query rows (q, dout) in the dQ pass
  const cuuint32_t q_rows = kernel == 2 ? kDqRows : kKeys;
  const cuuint32_t boxes[4][4] = {
      {64, q_rows, 1, 1}, {64, kKeys, 1, 1}, {64, kKeys, 1, 1}, {64, q_rows, 1, 1}};
  const void* bases[4] = {q, k, v, dout};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const int r = sm90::encode_bf16_4d(&maps[i], bases[i], dims + 4 * i, strides + 3 * i,
                                       boxes[i]);
    if (r != 0) return r;
  }
  BwdArgs a{lse2, delta, kernel == 1 ? dk : dq, dv, hq, hkv, sq, skv, d, sq_pad,
            causal, has_window, window, scale, scale * kLog2e};
  const int dp = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  cudaError_t err;
  if (kernel == 1) {
    err = dp == 64    ? launch_dkdv<64>(maps, a, batch, st)
          : dp == 128 ? launch_dkdv<128>(maps, a, batch, st)
                      : launch_dkdv<256>(maps, a, batch, st);
  } else {
    err = dp == 64    ? launch_dq<64>(maps, a, batch, st)
          : dp == 128 ? launch_dq<128>(maps, a, batch, st)
                      : launch_dq<256>(maps, a, batch, st);
  }
  return static_cast<int>(err);
}
