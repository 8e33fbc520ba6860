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
// cannot fill (k > n_valid, or docs scoring -inf, which are no
// candidates) come out (-inf, 2^31 - 1); a real id is never repeated.  A NaN score ranks above +inf, whatever its sign, as
// the TPU kernel's first-match arg-max ranks it; NaNs tie among
// themselves and break the tie by id.  The [B, N] score matrix never
// reaches device memory.
//
// What bounds it.  At the serving shape (B = 64, N = 65,536, D = 4,096,
// W = 128) the kernel must read the 1.07 GB doc matrix and its 33.5 MB of
// signatures once (0.33 ms at 3.35 TB/s).  The 2*B*N*D = 34.4 GFLOP of
// products would take 0.51 ms in f32 on the CUDA cores, so they go to the
// tensor cores, f32-accurate through a 3xTF32 split (the arithmetic that
// `hsf_score_3xtf32_ref` in kernels/hsf_score/ref.py emulates): with
// hi = tf32_rna(x), lo = tf32_rna(x - hi) for doc and query values,
//
//     q . doc ~= sum_k  hi_d hi_q + hi_d lo_q + lo_d hi_q     (f32 sums)
//
// 3 x 34.4 GFLOP at 495 TFLOP/s (0.21 ms), under the byte bound: the
// kernel is bound by bytes.
//
// Query split (`hsf_topk_split`).  The queries' hi and lo halves and
//   signature words, zero-padded to whole tiles, into the scratch.
// Pass 1 (`hsf_topk_tiles`).  Persistent CTAs, one per SM, each walking
//   its share of 128-doc tiles for one group of 64 queries (B <= 64
//   reads the doc matrix once).  A tile goes through the ring in steps of
//   32 feature columns (128 bytes, 128-byte swizzled) and, spread over the
//   tile, 4 signature words.  Warp-specialised:
//   - a loader warp issues one TMA box per operand and step into a ring
//     of 4 stages (full/empty mbarriers); an operand whose rows are not
//     16-byte aligned (D or W not a multiple of 4) goes by 4-byte
//     cp.async from its lanes instead;
//   - two consumer warpgroups, 64 docs each: a thread loads its rows of
//     the doc fragment from shared memory, splits them in registers, and
//     issues wgmma m64n64k8 tf32 with the docs as A (registers) and the
//     query halves as B (shared memory), 3 x 4 per step in one fixed
//     order; the containment test runs on the CUDA cores while the
//     products do (q & ~d == 0 word by word, unsigned bit patterns: words
//     carry the sign bit).  At a tile's end it writes alpha*cos +
//     beta*ind to a score tile (two in turn);
//   - seven epilogue warps merge each score tile into the CTA's running
//     top k per query and consumer (`merge_tile`): only docs ranking
//     before the running k-th entry enter, each at the rank counted from
//     the entries and entering docs before it, so the consumers never
//     wait on a selection.
// Pass 2 (`hsf_topk_merge`).  One CTA per query merges the CTAs' lists
//   with the comparator and k rounds, each picking the best candidate
//   strictly worse than the last pick.
//
// Bits.  A (query, doc) score depends on those two rows alone: the K
// order is fixed, nothing is split across CTAs, and a score is the same
// whatever the doc's place in a tile, the other queries of the batch, B
// or N.  So the IVF plane's exact and probe modes and the flat path give
// one pair the same bits, and duplicated doc rows tie exactly.
//
// The TPU kernel walked doc blocks in order with one VMEM carry and
// relied on that order for its tie rule.  Here CTAs run in any order, so
// the tie rule is carried by the comparator alone: the result is the
// same whatever order tiles finish in.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Nothing is allocated here; the caller passes the scratch.  Every launch
// is followed by cudaGetLastError(), whose code is returned.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;  // warpgroups doing the products
constexpr int kMergers = 7;    // epilogue warps
// + one loader warp: two more warpgroups
constexpr int kThreads = 128 * kConsumers + 32 * (1 + kMergers);
constexpr int kTileQ = 64;                   // queries per CTA: the wgmma N
constexpr int kTileN = 64 * kConsumers;      // docs per tile: 64 (M) per consumer
constexpr int kChunkD = 32;  // feature columns per step: one 128-byte swizzled row
constexpr int kChunkW = 4;   // signature words per step
constexpr int kStages = 4;   // steps in flight through the ring
constexpr int kLag = 2;      // steps a loader lane's cp.async copies may stay pending
constexpr int kLdS = 64 + 1;  // score tile pitch (a consumer's 64 docs)
constexpr int kMaxK = 128;    // widest k
// One stage: q_hi and q_lo [64][32] and docs [128][32] f32, 128-byte
// swizzled (1024-byte aligned), then doc and query signature words.
constexpr int kQBytes = kTileQ * kChunkD * 4;
constexpr int kDocBytes = kTileN * kChunkD * 4;
constexpr int kDSigBytes = kTileN * kChunkW * 4;
constexpr int kQSigBytes = kTileQ * kChunkW * 4;
constexpr int kStageBytes = 2 * kQBytes + kDocBytes + kDSigBytes + kQSigBytes;
// the ring, then per consumer two score tiles [64][kLdS] and the k-th
// entry of each query's running list, a list buffer per epilogue warp,
// then the barriers
constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                         (size_t)kConsumers * kTileQ * (2 * kLdS * 4 + 8) +
                         kMergers * kMaxK * 8 + (2 * kStages + 4 * kConsumers) * 8;
constexpr int kMergeThreads = 256;
constexpr int32_t kSentinel = 0x7fffffff;

static_assert(kLag < kStages, "a stage is signalled before it is reused");
static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle alignment");

// (av, ai) ranks strictly before (bv, bi): score desc, then id asc, with
// every NaN above +inf and NaNs equal among themselves.
__device__ __forceinline__ bool better(float av, int32_t ai, float bv,
                                       int32_t bi) {
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return an && (!bn || ai < bi);
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

// Round to TF32 (10 explicit mantissa bits), to nearest, ties away from
// zero; the low 13 bits of the result are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// Word offset of (row, col) in a [rows][32] tile of 4-byte words with the
// 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ int swz(int row, int col) {
  return row * 32 + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}

// The query operands, padded for pass 1: split[0] = hi, split[1] = lo
// ([bp][dp] each, hi = tf32(q), lo = tf32(q - hi)), then the signature
// words [bp][wp]; zero outside [b, d] and [b, w].
__global__ void hsf_topk_split(const float* __restrict__ q,
                               const uint32_t* __restrict__ qsig, int b, int d,
                               int w, int bp, int dp, int wp,
                               uint32_t* __restrict__ out) {
  const long long nq = (long long)bp * dp, ns = (long long)bp * wp;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < nq + ns; i += stride) {
    if (i < nq) {
      const int r = (int)(i / dp), c = (int)(i % dp);
      const float x = (r < b && c < d) ? q[(long long)r * d + c] : 0.f;
      const uint32_t hi = tf32_rna(x);
      out[i] = hi;
      out[nq + i] = tf32_rna(x - __uint_as_float(hi));
    } else {
      const long long j = i - nq;
      const int r = (int)(j / wp), c = (int)(j % wp);
      out[2 * nq + j] = (r < b && c < w) ? qsig[(long long)r * w + c] : 0u;
    }
  }
}

// The first tile's list: its 64 candidates (cv, ci at positions lane and
// lane + 32; `in` false for docs that are no candidates) sorted by a
// bitonic network across the warp under (score desc, id asc), the first k
// written in rank order and sentinels after them.
__device__ void first_tile(float (&cv)[2], int32_t (&ci)[2], const bool (&in)[2],
                           int k, float* vals, int32_t* ids, float& kth_v,
                           int32_t& kth_i, int lane) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (!in[c]) {
      cv[c] = -INFINITY;
      ci[c] = kSentinel;
    }
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // the pair is (lane, lane + 32), in one lane
        if (better(cv[1], ci[1], cv[0], ci[0])) {
          const float v = cv[0];
          const int32_t i = ci[0];
          cv[0] = cv[1];
          ci[0] = ci[1];
          cv[1] = v;
          ci[1] = i;
        }
        continue;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int pos = 32 * c + lane;
        const float ov = __shfl_xor_sync(0xffffffffu, cv[c], stride);
        const int32_t oi = __shfl_xor_sync(0xffffffffu, ci[c], stride);
        // the lower position keeps the better entry where the run sorts
        // best-first ((pos & size) == 0), the worse one otherwise
        const bool lower = (pos & stride) == 0;
        const bool best_first = (pos & size) == 0;
        const bool other_better = better(ov, oi, cv[c], ci[c]);
        if (other_better == (lower == best_first)) {
          cv[c] = ov;
          ci[c] = oi;
        }
      }
    }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int pos = 32 * c + lane;
    if (pos < k) {
      vals[pos] = cv[c];
      ids[pos] = ci[c];
    }
    if (pos == k - 1) {
      kth_v = cv[c];
      kth_i = ci[c];
    }
  }
  for (int e = 64 + lane; e < k; e += 32) {
    vals[e] = -INFINITY;
    ids[e] = kSentinel;
    if (e == k - 1) {
      kth_v = -INFINITY;
      kth_i = kSentinel;
    }
  }
  __syncwarp();
}

// One warp merges one query's 64 tile scores `row` (docs base ..
// base + 63; those past `nvalid` are no candidates) into its running
// list (vals, ids: k entries in rank order, sentinels last; not yet
// written when tile_no == 0), loaded by the caller into rv, ri (entry
// lane + 32r, sentinels past k), keeping its k-th entry (kth_v, kth_i)
// current.  Only docs ranking before the k-th entry enter (after the
// first tiles, a few).  Ranks come from counts, all lanes at once: an
// entering doc's rank is the number of running entries before it (a
// binary search of the list, staged in the warp's buffer buf_v/buf_i)
// plus the entering docs before it; a running entry moves down by the
// entering docs before it.
__device__ void merge_tile(const float* row, int base, int nvalid, int tile_no,
                           int k, const float (&rv)[kMaxK / 32],
                           const int32_t (&ri)[kMaxK / 32], float* vals,
                           int32_t* ids, float& kth_v, int32_t& kth_i,
                           float* buf_v, int32_t* buf_i, int lane) {
  const float tv = tile_no ? kth_v : -INFINITY;
  const int32_t ti = tile_no ? kth_i : kSentinel;
  float cv[2];
  int32_t ci[2];
  bool in[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int local = lane + 32 * c;
    cv[c] = row[local];
    ci[c] = base + local;
    // a -inf score is no candidate: its slot stays (-inf, sentinel)
    in[c] = local < nvalid && cv[c] != -INFINITY &&
            better(cv[c], ci[c], tv, ti);
  }
  if (tile_no == 0) {
    first_tile(cv, ci, in, k, vals, ids, kth_v, kth_i, lane);
    return;
  }
  const uint32_t in0 = __ballot_sync(0xffffffffu, in[0]);
  const uint32_t in1 = __ballot_sync(0xffffffffu, in[1]);
  if ((in0 | in1) == 0u) return;
  int rank_r[kMaxK / 32], rank_c[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < kMaxK / 32; ++r) {
    const int e = lane + 32 * r;
    rank_r[r] = e;
    if (e < k) {
      buf_v[e] = rv[r];
      buf_i[e] = ri[r];
    }
  }
  __syncwarp();
  // the entering docs, one at a time (the same for every lane)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t bits = half ? in1 : in0;
    while (bits) {
      const int j = __ffs(bits) - 1 + 32 * half;
      bits &= bits - 1;
      const float vj = row[j];
      const int32_t ij = base + j;
#pragma unroll
      for (int c = 0; c < 2; ++c) rank_c[c] += better(vj, ij, cv[c], ci[c]);
#pragma unroll
      for (int r = 0; r < kMaxK / 32; ++r)
        if (32 * r < k) rank_r[r] += better(vj, ij, rv[r], ri[r]);
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!in[c]) continue;
    int lo = 0, hi = k;  // entries before the doc: a prefix of the list
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (better(buf_v[mid], buf_i[mid], cv[c], ci[c]))
        lo = mid + 1;
      else
        hi = mid;
    }
    rank_c[c] += lo;
  }
#pragma unroll
  for (int r = 0; r < kMaxK / 32; ++r)
    if (lane + 32 * r < k && rank_r[r] < k) {
      vals[rank_r[r]] = rv[r];
      ids[rank_r[r]] = ri[r];
      if (rank_r[r] == k - 1) {
        kth_v = rv[r];
        kth_i = ri[r];
      }
    }
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (in[c] && rank_c[c] < k) {
      vals[rank_c[c]] = cv[c];
      ids[rank_c[c]] = ci[c];
      if (rank_c[c] == k - 1) {
        kth_v = cv[c];
        kth_i = ci[c];
      }
    }
  __syncwarp();
}

// A consumer thread's doc fragment of one step (rows r0, r1; k8 steps
// ks = 0..3 of the 32 columns) from the stage's swizzled doc tile, split
// into TF32 halves hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split_fragment(const unsigned char* st, int r0,
                                               int r1, int t,
                                               uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4]) {
  const float* sd = reinterpret_cast<const float*>(st + 2 * kQBytes);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const float x[4] = {sd[swz(r0, 8 * ks + t)], sd[swz(r1, 8 * ks + t)],
                        sd[swz(r0, 8 * ks + t + 4)],
                        sd[swz(r1, 8 * ks + t + 4)]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[ks][e] = tf32_rna(x[e]);
      lo[ks][e] = tf32_rna(x[e] - __uint_as_float(hi[ks][e]));
    }
  }
}

struct Maps {
  CUtensorMap docs, sigs, qhi, qlo, qsig;
};

__global__ void __launch_bounds__(kThreads, 1)
    hsf_topk_tiles(const __grid_constant__ Maps maps,
                   const float* __restrict__ docs,
                   const uint32_t* __restrict__ sigs, int n, int d, int w,
                   int b, int n_eff, int k, float alpha, float beta,
                   int vec_docs, int vec_sigs, float* __restrict__ cand_v,
                   int32_t* __restrict__ cand_i) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // score tiles [consumer][buffer][query][doc], the k-th entry of each
  // running list [consumer][query], a list buffer per epilogue warp, then
  // the barriers
  float* scores_all = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  float* kth_v_all = scores_all + kConsumers * 2 * kTileQ * kLdS;
  int32_t* kth_i_all = reinterpret_cast<int32_t*>(kth_v_all + kConsumers * kTileQ);
  float* buf_v_all = reinterpret_cast<float*>(kth_i_all + kConsumers * kTileQ);
  int32_t* buf_i_all = reinterpret_cast<int32_t*>(buf_v_all + kMergers * kMaxK);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf_i_all + kMergers * kMaxK);
  uint64_t* empty = full + kStages;
  uint64_t* sfull = empty + kStages;  // [consumer * 2 + buffer]: written
  uint64_t* sempty = sfull + 2 * kConsumers;  // ... and merged

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, wwarp = warp & 3;
  const int q0 = blockIdx.y * kTileQ;

  const int ntiles = (n + kTileN - 1) / kTileN;
  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int dsteps = (d + kChunkD - 1) / kChunkD;
  const int wsteps = (w + kChunkW - 1) / kChunkW;
  const int steps = max(1, max(dsteps, wsteps));  // per tile
  // signature chunk ws arrives at step ws * spw of its tile, so the
  // containment work spreads over the tile
  const int spw = wsteps > 0 ? max(1, steps / wsteps) : 1;
  const int total = my_tiles * steps;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 2);                // TMA issue + cp.async landed
      mbar_init(&empty[s], kConsumers * 4);  // every consumer warp
    }
    for (int i = 0; i < 2 * kConsumers; ++i) {
      mbar_init(&sfull[i], 128);      // the consumer's threads
      mbar_init(&sempty[i], kMergers * 32);  // the epilogue warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // Loader warp.  Step `step` of this CTA is tile blockIdx.x +
    // (step / steps) * gridDim.x, feature chunk s = step % steps and
    // signature chunk ws (if any).  Lane 0 issues the TMA boxes; operands whose rows
    // are not 16-byte aligned go by cp.async from all lanes; once every
    // lane's copies of a step have landed (kLag steps later) and been
    // handed to wgmma by a proxy fence, lane 0 arrives again.
    for (int step = 0; step < total; ++step) {
      const int stage = step % kStages;
      if (step >= kStages) mbar_wait(&empty[stage], (step / kStages - 1) & 1);
      const int tile = blockIdx.x + (step / steps) * gridDim.x;
      const int s = step % steps, n0 = tile * kTileN;
      unsigned char* st = ring + stage * kStageBytes;
      uint32_t* sqh = reinterpret_cast<uint32_t*>(st);
      uint32_t* sql = sqh + kQBytes / 4;
      uint32_t* sd = sql + kQBytes / 4;
      uint32_t* sds = sd + kDocBytes / 4;
      uint32_t* sqs = sds + kTileN * kChunkW;
      const int ws = s % spw == 0 && s / spw < wsteps ? s / spw : -1;
      const int c0 = s * kChunkD, w0 = ws * kChunkW;
      if (lane == 0) {
        uint32_t bytes = 0;
        if (s < dsteps) bytes += 2 * kQBytes + (vec_docs ? kDocBytes : 0);
        if (ws >= 0) bytes += kQSigBytes + (vec_sigs ? kDSigBytes : 0);
        mbar_arrive_expect_tx(&full[stage], bytes);
        if (s < dsteps) {
          tma_load_2d(sqh, &maps.qhi, &full[stage], c0, q0);
          tma_load_2d(sql, &maps.qlo, &full[stage], c0, q0);
          if (vec_docs) tma_load_2d(sd, &maps.docs, &full[stage], c0, n0);
        }
        if (ws >= 0) {
          tma_load_2d(sqs, &maps.qsig, &full[stage], w0, q0);
          if (vec_sigs) tma_load_2d(sds, &maps.sigs, &full[stage], w0, n0);
        }
      }
      if (s < dsteps && !vec_docs)
        for (int i = lane; i < kTileN * kChunkD; i += 32) {
          const int r = i >> 5, c = i & 31;
          const bool ok = n0 + r < n && c0 + c < d;
          cp_async4(sd + swz(r, c),
                    ok ? docs + (long long)(n0 + r) * d + c0 + c : docs, ok);
        }
      if (ws >= 0 && !vec_sigs)
        for (int i = lane; i < kTileN * kChunkW; i += 32) {
          const int r = i >> 2, c = i & 3;
          const bool ok = n0 + r < n && w0 + c < w;
          cp_async4(sds + i,
                    ok ? sigs + (long long)(n0 + r) * w + w0 + c : sigs, ok);
        }
      cp_async_commit();
      if (step >= kLag) {
        cp_async_wait<kLag>();
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[(step - kLag) % kStages]);
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncwarp();
    if (lane == 0)
      for (int step = max(0, total - kLag); step < total; ++step)
        mbar_arrive(&full[step % kStages]);
    return;
  }

  if (warp > 4 * kConsumers) {
    // Epilogue warps: merge each consumer's score tiles into its running
    // top k per query (cand_* [query][CTA][consumer][k], in rank order,
    // sentinels last), while the consumers go on with the next tile.
    // Only docs ranking before the running k-th entry take part, each
    // placed at its rank under (score desc, id asc), the entries it
    // passes moving down one.  Docs >= n_eff take no part.
    const int ew = warp - 4 * kConsumers - 1;  // 0 .. kMergers - 1
    for (int tile_no = 0; tile_no < my_tiles; ++tile_no) {
      for (int c = 0; c < kConsumers; ++c) {
        const int sb = c * 2 + (tile_no & 1);
        mbar_wait(&sfull[sb], (tile_no >> 1) & 1);
        const float* scores = scores_all + sb * kTileQ * kLdS;
        float* kth_v = kth_v_all + c * kTileQ;
        int32_t* kth_i = kth_i_all + c * kTileQ;
        const int base = (blockIdx.x + tile_no * gridDim.x) * kTileN + c * 64;
        const int nvalid = min(64, n_eff - base);  // may be <= 0
        // list of query qq: cand_* + list(qq); each query's list is
        // loaded one query ahead, so its latency hides behind a merge
        auto list = [&](int qq) {
          return (((long long)(q0 + qq) * gridDim.x + blockIdx.x) *
                      kConsumers + c) * k;
        };
        float nv[kMaxK / 32];
        int32_t ni[kMaxK / 32];
        auto load_list = [&](int qq) {
#pragma unroll
          for (int r = 0; r < kMaxK / 32; ++r) {
            const int e = lane + 32 * r;
            const bool held = tile_no > 0 && e < k;
            nv[r] = held ? cand_v[list(qq) + e] : -INFINITY;
            ni[r] = held ? cand_i[list(qq) + e] : kSentinel;
          }
        };
        if (ew < kTileQ && q0 + ew < b) load_list(ew);
        for (int qq = ew; qq < kTileQ && q0 + qq < b; qq += kMergers) {
          float rv[kMaxK / 32];
          int32_t ri[kMaxK / 32];
#pragma unroll
          for (int r = 0; r < kMaxK / 32; ++r) {
            rv[r] = nv[r];
            ri[r] = ni[r];
          }
          const int next = qq + kMergers;
          if (next < kTileQ && q0 + next < b) load_list(next);
          merge_tile(scores + qq * kLdS, base, nvalid, tile_no, k, rv, ri,
                     cand_v + list(qq), cand_i + list(qq), kth_v[qq],
                     kth_i[qq], buf_v_all + ew * kMaxK,
                     buf_i_all + ew * kMaxK, lane);
        }
        mbar_arrive(&sempty[sb]);
      }
    }
    return;
  }

  // Consumer warpgroup `wg`: docs wg*64 .. wg*64 + 63 of every tile.
  const int g = lane >> 2, t = lane & 3;  // accumulator coordinates
  const int r0 = wg * 64 + wwarp * 16 + g, r1 = r0 + 8;  // rows in the tile
  float acc[32];
  uint32_t ok = 0;
  int tile_no = 0;
  for (int step = 0; step < total; ++step) {
    const int stage = step % kStages, s = step % steps;
    const unsigned char* st = ring + stage * kStageBytes;
    mbar_wait(&full[stage], (step / kStages) & 1);
    if (s == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      ok = 0xffffffffu;
    }
    if (s < dsteps) {
      // The doc fragment straight from shared memory, split in registers;
      // three TF32 products per k8 step in one fixed order.
      uint32_t hi[4][4], lo[4][4];
      split_fragment(st, r0, r1, t, hi, lo);
      const uint32_t qh = smem_u32(st), ql = qh + kQBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dh = desc_sw128(qh + ks * 32, 16, 1024);
        const uint64_t dl = desc_sw128(ql + ks * 32, 16, 1024);
        wgmma_rs_tf32_n64(acc, hi[ks], dh);  // hi . hi
        wgmma_rs_tf32_n64(acc, hi[ks], dl);  // doc hi . query lo
        wgmma_rs_tf32_n64(acc, lo[ks], dh);  // doc lo . query hi
      }
      wgmma_commit();
    }
    if (s % spw == 0 && s / spw < wsteps &&
        __any_sync(0xffffffffu, ok != 0u)) {
      // Containment on the CUDA cores while the tensor cores run: a
      // query word with a bit the doc word lacks (q & ~d != 0) clears bit
      // 4j + e of `ok`, the pair (doc row r0 + 8*(e >> 1), query
      // 8j + 2t + (e & 1)).  A warp whose pairs have all failed skips
      // the tile's later words (most do, after the first chunk).
      const uint32_t* sds =
          reinterpret_cast<const uint32_t*>(st + 2 * kQBytes + kDocBytes);
      const uint32_t* sqs = sds + kTileN * kChunkW;
      const uint4 d0 = *reinterpret_cast<const uint4*>(sds + r0 * 4);
      const uint4 d1 = *reinterpret_cast<const uint4*>(sds + r1 * 4);
      uint32_t miss = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint4 qw =
              *reinterpret_cast<const uint4*>(sqs + (8 * j + 2 * t + c) * 4);
          miss |= (uint32_t)(((qw.x & ~d0.x) | (qw.y & ~d0.y) |
                              (qw.z & ~d0.z) | (qw.w & ~d0.w)) != 0u)
                  << (4 * j + c);
          miss |= (uint32_t)(((qw.x & ~d1.x) | (qw.y & ~d1.y) |
                              (qw.z & ~d1.z) | (qw.w & ~d1.w)) != 0u)
                  << (4 * j + 2 + c);
        }
      ok &= ~miss;
    }
    wgmma_wait<0>();  // on every path, whether this step had products or not
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with it
    if (s != steps - 1) continue;

    // End of the tile: alpha*cos + beta*ind with separate roundings (no
    // FMA contraction), as the plain version computes it, into a score
    // tile [query][doc] for the epilogue warps (two tiles in turn).
    const int sb = wg * 2 + (tile_no & 1);
    if (tile_no >= 2) mbar_wait(&sempty[sb], ((tile_no >> 1) - 1) & 1);
    float* scores = scores_all + sb * kTileQ * kLdS;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int doc = (e < 2 ? r0 : r1) - wg * 64, qq = 8 * j + 2 * t + (e & 1);
        const float ind = ((ok >> (4 * j + e)) & 1u) ? 1.f : 0.f;
        scores[qq * kLdS + doc] =
            __fadd_rn(__fmul_rn(alpha, acc[4 * j + e]), __fmul_rn(beta, ind));
      }
    mbar_arrive(&sfull[sb]);
    ++tile_no;
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
  // the last pick starts above every candidate: a NaN of id -1
  float last_v = __int_as_float(0x7fc00000);
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

// Pass 1's CTAs for n docs: one per SM of the current device (persistent),
// at most one per 128-doc tile; the candidate scratch holds
// b * ctas * hsf_topk_lists_per_cta() * k entries.
int hsf_topk_ctas_for(int n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int tiles = (n + kTileN - 1) / kTileN;
  return tiles < sms ? tiles : sms;
}

// 4-byte words of the query scratch: hi and lo [bp][dp] and the
// signature words [bp][wp], bp, dp, wp the padded b, d, w.
long long hsf_topk_split_words(int b, int d, int w) {
  const long long bp = (b + kTileQ - 1) / kTileQ * kTileQ;
  const long long dp = (d + kChunkD - 1) / kChunkD * kChunkD;
  const long long wp = (w + kChunkW - 1) / kChunkW * kChunkW;
  const long long words = 2 * bp * dp + bp * wp;
  return words > 64 ? words : 64;  // a real buffer for the maps to name
}

int hsf_topk_lists_per_cta() { return kConsumers; }

int hsf_topk_max_k() { return kMaxK; }

// Launches the query split, pass 1 and the merge on `stream`; returns a
// cudaError_t code (0 = ok).
int hsf_topk_launch(const float* docs, const int32_t* sigs, const float* q,
                    const int32_t* qsig, int n, int d, int w, int b,
                    int n_valid, int k, float alpha, float beta,
                    int32_t* split, float* cand_v, int32_t* cand_i,
                    float* out_v, int32_t* out_i, void* stream) {
  if (n < 1 || b < 1 || d < 0 || w < 0 || k < 1 || k > kMaxK ||
      (b + kTileQ - 1) / kTileQ > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_eff = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
  const int bp = (b + kTileQ - 1) / kTileQ * kTileQ;
  const int dp = (d + kChunkD - 1) / kChunkD * kChunkD;
  const int wp = (w + kChunkW - 1) / kChunkW * kChunkW;
  const int ctas = hsf_topk_ctas_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* sp = reinterpret_cast<uint32_t*>(split);
  const long long words = (long long)bp * (dp + wp);
  const int split_blocks =
      (int)((words + 255) / 256 < 1024 ? (words + 255) / 256 : 1024);
  hsf_topk_split<<<split_blocks > 0 ? split_blocks : 1, 256, 0, s>>>(
      q, reinterpret_cast<const uint32_t*>(qsig), b, d, w, bp, dp, wp, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // TMA for every operand whose rows start on 16-byte boundaries (the
  // padded query scratch always; docs and signatures when D and W are
  // multiples of 4), cp.async for the others; maps of operands that take
  // cp.async are never read, so they describe the scratch.
  const int vec_docs =
      d > 0 && d % 4 == 0 && reinterpret_cast<uintptr_t>(docs) % 16 == 0;
  const int vec_sigs =
      w > 0 && w % 4 == 0 && reinterpret_cast<uintptr_t>(sigs) % 16 == 0;
  const long long nq = (long long)bp * dp;
  const int dpx = dp > 0 ? dp : kChunkD, wpx = wp > 0 ? wp : kChunkW;
  Maps maps;
  int e = hopper::make_map_2d(&maps.qhi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sp,
                              dpx, bp, dpx * 4, kChunkD, kTileQ,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!e)
    e = hopper::make_map_2d(&maps.qlo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            sp + nq, dpx, bp, dpx * 4, kChunkD, kTileQ,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (!e)
    e = hopper::make_map_2d(&maps.qsig, CU_TENSOR_MAP_DATA_TYPE_UINT32,
                            sp + 2 * nq, wpx, bp, wpx * 4, kChunkW, kTileQ,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!e)
    e = vec_docs ? hopper::make_map_2d(&maps.docs,
                                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32, docs,
                                       d, n, (long long)d * 4, kChunkD,
                                       kTileN, CU_TENSOR_MAP_SWIZZLE_128B)
                 : hopper::make_map_2d(&maps.docs,
                                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sp,
                                       dpx, bp, dpx * 4, kChunkD, kTileN,
                                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (!e)
    e = vec_sigs ? hopper::make_map_2d(&maps.sigs,
                                       CU_TENSOR_MAP_DATA_TYPE_UINT32, sigs,
                                       w, n, (long long)w * 4, kChunkW,
                                       kTileN, CU_TENSOR_MAP_SWIZZLE_NONE)
                 : hopper::make_map_2d(&maps.sigs,
                                       CU_TENSOR_MAP_DATA_TYPE_UINT32, sp,
                                       wpx, bp, wpx * 4, kChunkW, kTileN,
                                       CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e) return e;
  err = cudaFuncSetAttribute(hsf_topk_tiles,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  hsf_topk_tiles<<<dim3(ctas, bp / kTileQ), kThreads, kSmem, s>>>(
      maps, docs, reinterpret_cast<const uint32_t*>(sigs), n, d, w, b, n_eff,
      k, alpha, beta, vec_docs, vec_sigs, cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hsf_topk_merge<<<b, kMergeThreads, 0, s>>>(cand_v, cand_i,
                                             ctas * kConsumers * k, k,
                                             out_v, out_i);
  return (int)cudaGetLastError();
}

const char* hsf_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
