// tanimoto: batched Tanimoto top-k over packed fingerprints, for sm_90a.
//
// Replaces the Pallas kernel `tanimoto_blocks_pallas` (body
// `_tanimoto_kernel`) of src/repro/kernels/tanimoto/kernel.py, wrapped there
// by `tanimoto_topk_pallas`.  (Q, W) uint32 queries against an (N, W)
// uint32 plane with (N,) int32 row popcounts in; (Q, k) float32 scores and
// (Q, k) int32 rows out, bit-exact with the reference `tanimoto_topk_ref`:
//
//   c = sum_w popc(q[w] & d[w]),  u = |q| + |d| - c,
//   score = u > 0 ? float(c) / float(u) (IEEE round to nearest) : 0,
//   order (score desc, row asc), pads (-1.0, -1) when fewer than k rows.
//
// Bound on an H100: operations.  Every query meets every row, so the work is
// Q * N * W population counts, and the card retires 16 of those per clock
// per SM against 64 ANDs or adds.  The plane's N * (4W + 4) bytes are read
// once per group of up to 8 queries; even if every group read them from
// device memory, at W = 32 the popcounts of a group take longer than its
// read (8 * 32 popcounts per 132 bytes).
//
// Design (two stages, one host call):
//
//   Stage 1: a warp owns `QPW` queries and one slice of rows.  Lane l scores
//   rows base+l of each 32-row batch against all QPW queries (the row's
//   words are loaded once, the query words are broadcast from shared
//   memory), so the plane is read once per query group, not once per query.
//   Each (query, slice) keeps a top-k list in shared memory, sorted by
//   (score desc, row asc).  When even one query per warp does not fit
//   (k above about 7,260 at W = 32), the lists live in the global
//   (Q, slices, k) scratch instead, one query per warp, with the same
//   insert rule, so stage 2 and the answer do not change.  A row enters only if it beats the list's last
//   entry on (score, row); candidates of a batch enter one at a time in
//   lane order and the rest are re-checked against the new last entry.  The
//   warp inserts cooperatively: it counts the entries that beat the new one
//   (its position) and shifts the tail down by one.  Lists start full of
//   pads (-1.0, INT_MAX), which every real row beats.
//
//   Stage 2: a warp per query merges its slices' sorted lists: k rounds of
//   a warp arg-max on (score desc, row asc) over the list heads (each lane
//   holds the best head of its own lists), the winner's list advancing by
//   one.  Once the best head is a pad, the rest of the output is pads.
//
//   Every comparison is on (score, row), a total order, so the result does
//   not depend on the slicing, the lane order or the merge order.  Build
//   without --use_fast_math: the divide is __fdiv_rn.
//
// Plain C interface: the caller passes device pointers, the plan (slices,
// queries per warp) and scratch for the stage-1 lists, and the CUDA stream;
// the function returns the first CUDA error of the two launches.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps per stage-1 block, each with its own slice
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ bool better(float s1, int r1, float s2, int r2) {
  return s1 > s2 || (s1 == s2 && r1 < r2);
}

// Insert (s, r) into the sorted list (ls, li) of length k; the caller has
// checked that it beats the last entry.  Whole warp, converged.
__device__ void warp_insert(float* ls, int* li, int k, float s, int r,
                            int lane) {
  int pos = 0;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    const bool b = j < k && better(ls[j], li[j], s, r);
    pos += __popc(__ballot_sync(kFull, b));
  }
  // shift [pos, k-1) to [pos+1, k), highest chunk first: a chunk reads
  // below its own range and is written before the next one reads
  for (int hi = k - 1; hi > pos; hi -= 32) {
    const int j = hi - lane;
    float vs = 0.f;
    int vi = 0;
    const bool move = j > pos;
    if (move) {
      vs = ls[j - 1];
      vi = li[j - 1];
    }
    __syncwarp();
    if (move) {
      ls[j] = vs;
      li[j] = vi;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[pos] = s;
    li[pos] = r;
  }
  __syncwarp();
}

// GLOBAL: the lists are the warp's own rows of the (nq, n_slices, k) output
// scratch, not shared memory (QPW is 1 then).
template <int QPW, bool VEC4, bool GLOBAL>
__global__ void __launch_bounds__(kWarps * 32)
tanimoto_slices(const uint32_t* __restrict__ db, const int* __restrict__ dbc,
                const uint32_t* __restrict__ q, const int* __restrict__ qc,
                int n, int w, int nq, int k, int n_slices, int rows_per_slice,
                float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sq = reinterpret_cast<uint32_t*>(smem);  // (QPW, w) query words
  float* lists_s = reinterpret_cast<float*>(sq + QPW * w);
  int* lists_i = reinterpret_cast<int*>(lists_s + kWarps * QPW * k);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QPW;  // query group
  const int nql = min(QPW, nq - q0);
  const int slice = blockIdx.y * kWarps + warp;

  for (int t = threadIdx.x; t < QPW * w; t += blockDim.x) {
    const int qi = t / w;
    sq[t] = qi < nql ? q[static_cast<int64_t>(q0 + qi) * w + (t - qi * w)] : 0u;
  }
  float* my_s = lists_s + warp * QPW * k;
  int* my_i = lists_i + warp * QPW * k;
  if constexpr (GLOBAL) {
    static_assert(QPW == 1, "global lists hold one query per warp");
    const int64_t at = (static_cast<int64_t>(q0) * n_slices + slice) * k;
    my_s = out_s + at;
    my_i = out_i + at;
  }
  for (int t = lane; t < QPW * k; t += 32) {
    my_s[t] = -1.0f;
    my_i[t] = INT_MAX;
  }
  int qcnt[QPW];
  float worst_s[QPW];
  int worst_i[QPW];
#pragma unroll
  for (int qi = 0; qi < QPW; ++qi) {
    qcnt[qi] = qi < nql ? qc[q0 + qi] : 0;
    worst_s[qi] = -1.0f;
    worst_i[qi] = INT_MAX;
  }
  __syncthreads();

  const int64_t lo64 = static_cast<int64_t>(slice) * rows_per_slice;
  const int64_t hi64 = lo64 + rows_per_slice;
  const int64_t row_lo = lo64 < n ? lo64 : n;
  const int64_t row_hi = hi64 < n ? hi64 : n;
  for (int64_t base = row_lo; base < row_hi; base += 32) {
    const bool valid = base + lane < row_hi;
    const int row = valid ? static_cast<int>(base + lane) : INT_MAX;
    int acc[QPW];
#pragma unroll
    for (int qi = 0; qi < QPW; ++qi) acc[qi] = 0;
    int dcount = 0;
    if (valid) {
      dcount = __ldg(dbc + row);
      if (VEC4) {
        const int w4 = w >> 2;
        const uint4* d4 = reinterpret_cast<const uint4*>(
            db + static_cast<int64_t>(row) * w);
        const uint4* q4 = reinterpret_cast<const uint4*>(sq);
        for (int c = 0; c < w4; ++c) {
          const uint4 d = __ldg(d4 + c);
#pragma unroll
          for (int qi = 0; qi < QPW; ++qi) {
            const uint4 x = q4[qi * w4 + c];
            acc[qi] += __popc(d.x & x.x) + __popc(d.y & x.y) +
                       __popc(d.z & x.z) + __popc(d.w & x.w);
          }
        }
      } else {
        const uint32_t* d1 = db + static_cast<int64_t>(row) * w;
        for (int c = 0; c < w; ++c) {
          const uint32_t d = __ldg(d1 + c);
#pragma unroll
          for (int qi = 0; qi < QPW; ++qi) acc[qi] += __popc(d & sq[qi * w + c]);
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QPW; ++qi) {
      if (qi >= nql) break;  // uniform across the warp
      const int u = qcnt[qi] + dcount - acc[qi];
      const float score =
          u > 0 ? __fdiv_rn(static_cast<float>(acc[qi]), static_cast<float>(u))
                : 0.0f;
      bool cand = valid && better(score, row, worst_s[qi], worst_i[qi]);
      unsigned mask = __ballot_sync(kFull, cand);
      float* ls = my_s + qi * k;
      int* li = my_i + qi * k;
      while (mask) {
        const int src = __ffs(mask) - 1;
        const float s = __shfl_sync(kFull, score, src);
        const int r = __shfl_sync(kFull, row, src);
        warp_insert(ls, li, k, s, r, lane);
        worst_s[qi] = ls[k - 1];
        worst_i[qi] = li[k - 1];
        cand = cand && lane > src &&
               better(score, row, worst_s[qi], worst_i[qi]);
        mask = __ballot_sync(kFull, cand);
      }
    }
  }

  if constexpr (GLOBAL) return;  // the lists already are the output
  for (int qi = 0; qi < nql; ++qi) {
    const int64_t dst =
        (static_cast<int64_t>(q0 + qi) * n_slices + slice) * k;
    for (int j = lane; j < k; j += 32) {
      out_s[dst + j] = my_s[qi * k + j];
      out_i[dst + j] = my_i[qi * k + j];
    }
  }
}

// One warp per query: merge n_slices sorted lists of k into the top k.
__global__ void __launch_bounds__(32)
tanimoto_merge(const float* __restrict__ in_s, const int* __restrict__ in_i,
               int n_slices, int k, float* __restrict__ out_s,
               int* __restrict__ out_i) {
  extern __shared__ int heads[];  // (n_slices,) next entry of each list
  const int lane = threadIdx.x;
  const int64_t qbase = static_cast<int64_t>(blockIdx.x) * n_slices * k;
  for (int l = lane; l < n_slices; l += 32) heads[l] = 0;
  __syncwarp();

  // this lane's best head over its lists l = lane, lane + 32, ...
  float bs = -2.0f;  // below any pad: an empty lane never wins
  int bi = INT_MAX;
  int bl = -1;
  auto rescan = [&]() {
    bs = -2.0f;
    bi = INT_MAX;
    bl = -1;
    for (int l = lane; l < n_slices; l += 32) {
      const int h = heads[l];
      if (h >= k) continue;
      const int64_t at = qbase + static_cast<int64_t>(l) * k + h;
      const float s = in_s[at];
      const int r = in_i[at];
      if (better(s, r, bs, bi)) {
        bs = s;
        bi = r;
        bl = l;
      }
    }
  };
  rescan();

  const int64_t obase = static_cast<int64_t>(blockIdx.x) * k;
  for (int j = 0; j < k; ++j) {
    float ws = bs;
    int wi = bi;
    int wl = bl;
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFull, ws, off);
      const int oi = __shfl_xor_sync(kFull, wi, off);
      const int ol = __shfl_xor_sync(kFull, wl, off);
      // pads tie on (score, row); the list breaks the tie so that every
      // lane agrees on one winner
      if (better(os, oi, ws, wi) || (os == ws && oi == wi && ol < wl)) {
        ws = os;
        wi = oi;
        wl = ol;
      }
    }
    if (ws < 0.0f) {  // only pads are left
      for (int t = j + lane; t < k; t += 32) {
        out_s[obase + t] = -1.0f;
        out_i[obase + t] = -1;
      }
      return;
    }
    if (lane == 0) {
      out_s[obase + j] = ws;
      out_i[obase + j] = wi;
    }
    if (wl >= 0 && (wl & 31) == lane) {
      heads[wl] += 1;
      rescan();
    }
    __syncwarp();
  }
}

template <int QPW, bool VEC4, bool GLOBAL = false>
cudaError_t launch_slices(const uint32_t* db, const int* dbc,
                          const uint32_t* q, const int* qc, int n, int w,
                          int nq, int k, int n_slices, int rows_per_slice,
                          float* ss, int* si, cudaStream_t stream) {
  const size_t lists =
      GLOBAL ? 0 : (sizeof(float) + sizeof(int)) * kWarps * QPW * k;
  const size_t smem = sizeof(uint32_t) * QPW * w + lists;
  cudaError_t err = cudaFuncSetAttribute(
      tanimoto_slices<QPW, VEC4, GLOBAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + QPW - 1) / QPW, n_slices / kWarps);
  tanimoto_slices<QPW, VEC4, GLOBAL><<<grid, kWarps * 32, smem, stream>>>(
      db, dbc, q, qc, n, w, nq, k, n_slices, rows_per_slice, ss, si);
  return cudaGetLastError();
}

}  // namespace

// Shapes: db (n, w), dbc (n,), q (nq, w), qc (nq,); scratch ss/si
// (nq, n_slices, k); out (nq, k).  n_slices is a multiple of 4, qpw one of
// 1, 4, 8; global_lists (with qpw 1) keeps the stage-1 lists in ss/si.
// Returns a cudaError_t (0 on success; 1 = invalid value for a plan this
// file does not build).
extern "C" int tanimoto_topk_launch(const void* db, const void* dbc,
                                    const void* q, const void* qc, int n,
                                    int w, int nq, int k, int n_slices,
                                    int rows_per_slice, int qpw,
                                    int global_lists, void* ss, void* si,
                                    void* out_s, void* out_i, void* stream) {
  if (nq <= 0 || k <= 0 || w <= 0 || n_slices <= 0 || n_slices % kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const uint32_t*>(db);
  const auto* dc = static_cast<const int*>(dbc);
  const auto* qq = static_cast<const uint32_t*>(q);
  const auto* qcc = static_cast<const int*>(qc);
  auto* s1 = static_cast<float*>(ss);
  auto* i1 = static_cast<int*>(si);
  auto st = static_cast<cudaStream_t>(stream);
  // 16-byte row loads need 16-byte aligned rows
  const bool vec4 =
      (w % 4) == 0 && (reinterpret_cast<uintptr_t>(db) % 16) == 0;
  cudaError_t err;
#define TANIMOTO_SLICES(QPW_)                                                 \
  err = vec4 ? launch_slices<QPW_, true>(d, dc, qq, qcc, n, w, nq, k,         \
                                         n_slices, rows_per_slice, s1, i1, st) \
             : launch_slices<QPW_, false>(d, dc, qq, qcc, n, w, nq, k,        \
                                          n_slices, rows_per_slice, s1, i1,   \
                                          st)
  if (global_lists) {
    if (qpw != 1) return static_cast<int>(cudaErrorInvalidValue);
    err = vec4 ? launch_slices<1, true, true>(d, dc, qq, qcc, n, w, nq, k,
                                              n_slices, rows_per_slice, s1,
                                              i1, st)
               : launch_slices<1, false, true>(d, dc, qq, qcc, n, w, nq, k,
                                               n_slices, rows_per_slice, s1,
                                               i1, st);
  } else switch (qpw) {
    case 8: TANIMOTO_SLICES(8); break;
    case 4: TANIMOTO_SLICES(4); break;
    case 1: TANIMOTO_SLICES(1); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TANIMOTO_SLICES
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t heads = sizeof(int) * static_cast<size_t>(n_slices);
  if (heads > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  tanimoto_merge<<<nq, 32, heads, st>>>(s1, i1, n_slices, k,
                                        static_cast<float*>(out_s),
                                        static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
