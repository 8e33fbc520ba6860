// Fused batched HSF score + top-k for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `hsf_score_topk_pallas`
// (src/repro/kernels/hsf_score/hsf_score.py, body `_hsf_topk_kernel`).
// For a query batch q [B, D] f32 / qsig [B, W] int32 against docs
// [N, D] f32 / sigs [N, W] int32 it returns, per query, the k best of
//
//     score = alpha * (q . doc) + beta * all((sig & qsig) == qsig)
//
// over the rows id < n_valid, ordered (score desc, id asc).  Slots that
// cannot fill (k > n_valid) come out (-inf, 2^31 - 1); a real id is
// never repeated.  The [B, N] score matrix never reaches device memory.
//
// What bounds it.  At the serving shape (B = 64, N = 65,536, D = 4,096)
// the kernel reads the 1.07 GB doc matrix once (0.32 ms at 3.35 TB/s)
// and does 2*B*N*D = 34.4 GFLOP of f32 multiply-adds (0.51 ms at the
// 67 TFLOP/s f32 rate outside the tensor cores), so it is bound by
// operations.  The design therefore reads every doc byte exactly once and
// spends its effort on FMA throughput:
//
// Pass 1 (`hsf_topk_tiles`).  One CTA owns a tile of 128 docs and 64
//   queries (grid: doc tiles x query groups, so B <= 64 reads the doc
//   matrix once).  It walks the feature axis in 32-column stages through
//   shared memory, transposed so that each thread reads its 8 queries and
//   8 docs as float4s, and keeps an 8 x 8 register tile of dot products
//   (f32 FMA, full precision, no TF32).  The signature words take the
//   same stage path afterwards and fold into a per-(query, doc) bit of
//   the containment test, compared as unsigned bit patterns (words carry
//   the sign bit).  The epilogue writes the 64 x 128 scores to shared
//   memory; each warp then takes 16 queries and runs k rounds of a warp
//   arg-max under the explicit (score desc, id asc) comparator, each
//   round picking the best candidate strictly worse than the previous
//   pick.  The tile's k candidates per query go to a [B, tiles, k]
//   scratch.
// Pass 2 (`hsf_topk_merge`).  One CTA per query merges its tiles'
//   candidates with the same comparator and the same "strictly worse
//   than the last pick" rounds.
//
// The TPU kernel walked doc blocks in order with one VMEM carry and
// relied on that order for its tie rule.  Here CTAs run in any order, so
// the tie rule is carried by the comparator alone: the result is the
// same whatever order tiles finish in.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Nothing is allocated here; the caller passes the scratch.  Every launch
// is followed by cudaGetLastError(), whose code is returned.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // pass 1: 4 warps
constexpr int kTileQ = 64;        // queries per CTA
constexpr int kTileN = 128;       // docs per CTA
constexpr int kStage = 32;        // feature / signature columns per stage
constexpr int kLdQ = kTileQ + 4;  // stage row pitch (words), float4-aligned
constexpr int kLdN = kTileN + 4;
constexpr int kLdS = kTileN + 1;  // score tile pitch
constexpr int kLoadsQ = kTileQ * kStage / kThreads;  // 16
constexpr int kLoadsN = kTileN * kStage / kThreads;  // 32
constexpr int kMergeThreads = 256;
constexpr int kMaxK = 128;
constexpr int32_t kSentinel = 0x7fffffff;

static_assert(kThreads % 32 == 0 && kTileQ * kLdS >= kStage * (kLdQ + kLdN),
              "score tile must cover the stage buffers it reuses");

// (av, ai) ranks strictly before (bv, bi): score desc, then id asc.
__device__ __forceinline__ bool better(float av, int32_t ai, float bv,
                                       int32_t bi) {
  return av > bv || (av == bv && ai < bi);
}

// Warp-wide best (v, i); every lane ends with the winner.
__device__ __forceinline__ void warp_best(float& v, int32_t& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int32_t oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hsf_topk_tiles(const float* __restrict__ docs, const uint32_t* __restrict__ sigs,
               const float* __restrict__ q, const uint32_t* __restrict__ qsig,
               int n, int d, int w, int b, int n_eff, int k, float alpha,
               float beta, float* __restrict__ cand_v,
               int32_t* __restrict__ cand_i) {
  __shared__ __align__(16) uint32_t smem[kTileQ * kLdS];
  uint32_t* sq = smem;                   // [kStage][kLdQ]
  uint32_t* sn = smem + kStage * kLdQ;   // [kStage][kLdN]
  float* scores = reinterpret_cast<float*>(smem);  // [kTileQ][kLdS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tile = blockIdx.x;
  const int ntiles = gridDim.x;
  const int n0 = tile * kTileN;
  const int q0 = blockIdx.y * kTileQ;
  const int ty = tid >> 4;  // 0..7: queries ty*8 .. ty*8+7
  const int tx = tid & 15;  // 0..15: docs tx*4 .. +3 and 64+tx*4 .. +3

  const int dstages = (d + kStage - 1) / kStage;
  const int nstages = dstages + (w + kStage - 1) / kStage;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  uint32_t ok[8];  // bit j of ok[i]: query i contains doc j's signature
#pragma unroll
  for (int i = 0; i < 8; ++i) ok[i] = 0xffu;

  uint32_t rq[kLoadsQ], rn[kLoadsN];
  // Stage s: feature columns (s < dstages) or signature words, 32 wide.
  // Each warp reads 32 consecutive words of one row (coalesced); the
  // ragged edges (rows >= n or >= b, columns >= d or >= w) load as 0,
  // which adds nothing to a dot and passes the containment test.
  auto load = [&](int s) {
    const bool is_sig = s >= dstages;
    const int len = is_sig ? w : d;
    const int col = (is_sig ? s - dstages : s) * kStage + lane;
    const uint32_t* qsrc = is_sig ? qsig : reinterpret_cast<const uint32_t*>(q);
    const uint32_t* nsrc = is_sig ? sigs : reinterpret_cast<const uint32_t*>(docs);
    const bool col_ok = col < len;
#pragma unroll
    for (int r = 0; r < kLoadsQ; ++r) {
      const int row = q0 + (tid >> 5) + r * (kThreads / 32);
      rq[r] = (col_ok && row < b) ? __ldg(qsrc + (size_t)row * len + col) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kLoadsN; ++r) {
      const int row = n0 + (tid >> 5) + r * (kThreads / 32);
      rn[r] = (col_ok && row < n) ? __ldg(nsrc + (size_t)row * len + col) : 0u;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int r = 0; r < kLoadsQ; ++r)
      sq[lane * kLdQ + (tid >> 5) + r * (kThreads / 32)] = rq[r];
#pragma unroll
    for (int r = 0; r < kLoadsN; ++r)
      sn[lane * kLdN + (tid >> 5) + r * (kThreads / 32)] = rn[r];
  };

  if (nstages > 0) load(0);
  for (int s = 0; s < nstages; ++s) {
    store();
    __syncthreads();
    if (s + 1 < nstages) load(s + 1);  // prefetch overlaps the math below
    if (s < dstages) {
      const float* fq = reinterpret_cast<const float*>(sq);
      const float* fn = reinterpret_cast<const float*>(sn);
#pragma unroll 4
      for (int c = 0; c < kStage; ++c) {
        const float4 a0 = *reinterpret_cast<const float4*>(fq + c * kLdQ + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(fq + c * kLdQ + ty * 8 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(fn + c * kLdN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(fn + c * kLdN + 64 + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    } else {
#pragma unroll 2
      for (int c = 0; c < kStage; ++c) {
        const uint4 a0 = *reinterpret_cast<const uint4*>(sq + c * kLdQ + ty * 8);
        const uint4 a1 = *reinterpret_cast<const uint4*>(sq + c * kLdQ + ty * 8 + 4);
        const uint4 b0 = *reinterpret_cast<const uint4*>(sn + c * kLdN + tx * 4);
        const uint4 b1 = *reinterpret_cast<const uint4*>(sn + c * kLdN + 64 + tx * 4);
        const uint32_t av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const uint32_t bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint32_t hit = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) hit |= ((bv[j] & av[i]) == av[i]) << j;
          ok[i] &= hit;
        }
      }
    }
    __syncthreads();  // the next store overwrites this stage
  }

  // Epilogue: alpha*cos + beta*ind with separate roundings (no FMA
  // contraction), as the plain version computes it.
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      const float ind = ((ok[i] >> j) & 1u) ? 1.f : 0.f;
      scores[(ty * 8 + i) * kLdS + col] =
          __fadd_rn(__fmul_rn(alpha, acc[i][j]), __fmul_rn(beta, ind));
    }
  __syncthreads();

  // Per-tile top-k: warp `wid` owns queries wid*16 .. wid*16+15; lane l
  // holds docs l, l+32, l+64, l+96 of the tile.  Docs >= n_eff are not
  // candidates at all, so unfillable slots stay (-inf, sentinel).
  const int wid = tid >> 5;
  const int nvalid_tile = min(kTileN, n_eff - n0);  // may be <= 0
  const int rounds = min(k, max(nvalid_tile, 0));
  for (int r = wid * (kTileQ / 4); r < (wid + 1) * (kTileQ / 4); ++r) {
    const int qi = q0 + r;
    if (qi >= b) break;
    float sv[4];
    int32_t si[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int local = lane + 32 * c;
      sv[c] = scores[r * kLdS + local];
      si[c] = local < nvalid_tile ? n0 + local : kSentinel;
    }
    float* out_v = cand_v + ((size_t)qi * ntiles + tile) * k;
    int32_t* out_i = cand_i + ((size_t)qi * ntiles + tile) * k;
    float last_v = INFINITY;
    int32_t last_i = -1;
    for (int t = 0; t < rounds; ++t) {
      float bv = -INFINITY;
      int32_t bi = kSentinel;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (si[c] != kSentinel && better(last_v, last_i, sv[c], si[c]) &&
            better(sv[c], si[c], bv, bi)) {
          bv = sv[c];
          bi = si[c];
        }
      warp_best(bv, bi);
      if (lane == 0) {
        out_v[t] = bv;
        out_i[t] = bi;
      }
      last_v = bv;
      last_i = bi;
    }
    for (int t = rounds + lane; t < k; t += 32) {
      out_v[t] = -INFINITY;
      out_i[t] = kSentinel;
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
hsf_topk_merge(const float* __restrict__ cand_v,
               const int32_t* __restrict__ cand_i, int m, int k,
               float* __restrict__ out_v, int32_t* __restrict__ out_i) {
  __shared__ float wv[kMergeThreads / 32];
  __shared__ int32_t wi[kMergeThreads / 32];
  __shared__ float pick_v;
  __shared__ int32_t pick_i;
  const int qi = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const float* cv = cand_v + (size_t)qi * m;
  const int32_t* ci = cand_i + (size_t)qi * m;
  float last_v = INFINITY;
  int32_t last_i = -1;
  int t = 0;
  for (; t < k; ++t) {
    float bv = -INFINITY;
    int32_t bi = kSentinel;
    for (int j = tid; j < m; j += kMergeThreads) {
      const float v = cv[j];
      const int32_t i = ci[j];
      if (better(last_v, last_i, v, i) && better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      wv[wid] = bv;
      wi[wid] = bi;
    }
    __syncthreads();
    if (wid == 0) {
      bv = lane < kMergeThreads / 32 ? wv[lane] : -INFINITY;
      bi = lane < kMergeThreads / 32 ? wi[lane] : kSentinel;
      warp_best(bv, bi);
      if (lane == 0) {
        out_v[(size_t)qi * k + t] = bv;
        out_i[(size_t)qi * k + t] = bi;
        pick_v = bv;
        pick_i = bi;
      }
    }
    __syncthreads();
    last_v = pick_v;
    last_i = pick_i;
    if (last_i == kSentinel) {  // nothing left: the rest stay unfilled
      ++t;
      break;
    }
  }
  for (int r = t + tid; r < k; r += kMergeThreads) {
    out_v[(size_t)qi * k + r] = -INFINITY;
    out_i[(size_t)qi * k + r] = kSentinel;
  }
}

}  // namespace

extern "C" {

// Number of 128-doc tiles pass 1 splits n docs into (the scratch holds
// b * tiles * k candidates).
int hsf_topk_tiles_for(int n) { return (n + kTileN - 1) / kTileN; }

int hsf_topk_max_k() { return kMaxK; }

// Launches both passes on `stream`; returns a cudaError_t code (0 = ok).
int hsf_topk_launch(const float* docs, const int32_t* sigs, const float* q,
                    const int32_t* qsig, int n, int d, int w, int b,
                    int n_valid, int k, float alpha, float beta,
                    float* cand_v, int32_t* cand_i, float* out_v,
                    int32_t* out_i, void* stream) {
  if (n < 1 || b < 1 || d < 0 || w < 0 || k < 1 || k > kMaxK ||
      (b + kTileQ - 1) / kTileQ > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_eff = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
  const int ntiles = hsf_topk_tiles_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(ntiles, (b + kTileQ - 1) / kTileQ);
  hsf_topk_tiles<<<grid, kThreads, 0, s>>>(
      docs, reinterpret_cast<const uint32_t*>(sigs), q,
      reinterpret_cast<const uint32_t*>(qsig), n, d, w, b, n_eff, k, alpha,
      beta, cand_v, cand_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hsf_topk_merge<<<b, kMergeThreads, 0, s>>>(cand_v, cand_i, ntiles * k, k,
                                             out_v, out_i);
  return (int)cudaGetLastError();
}

const char* hsf_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
