// Top-k of a score vector for NVIDIA Hopper (sm_90a), as a radix select.
//
// Replaces the Pallas TPU kernel `top_k_pallas`
// (src/repro/kernels/topk/topk.py, body `_topk_kernel`).  For scores [N]
// f32 and k <= min(N, 128) it returns the k best (value, id) pairs ordered
// (score desc, id asc).  A -inf score is not a candidate: slots that no
// finite (or +inf) score fills come out (-inf, 2^31 - 1), which is what
// the TPU kernel gives whenever its sequential carry starts such a slot
// from its (-inf, sentinel) scratch.  A NaN ranks above +inf, whatever its
// sign and payload, as the TPU kernel's first-match arg-max ranks it; NaNs
// tie among themselves and break the tie by id, and each keeps its own id
// and its bits.
//
// What bounds it.  The function reads each score once and writes 8k
// bytes.  At N = 65,536 that is 256 KB (0.08 us at 3.35 TB/s), so a call
// is bound by launch latency; at N = 16,777,216 it is 64 MB, more than the
// 50 MB L2, 0.020 ms.  The TPU kernel ran k arg-max passes over each VMEM
// tile, cheap on its VPU; on Hopper that shape costs N*k compares and a
// barrier per round.  Here the work per score does not depend on k:
//
// - The key.  Each score maps to a uint32 that sorts as the float does
//   (-0.0 first made +0.0; a negative has all bits flipped, a positive its
//   sign bit set; -inf gets 0, below every candidate, and every NaN the
//   largest key, 0xffffffff, above +inf's 0xff800000).  The key of
//   an entry is (score key << nb) | (2^nb - 1 - id), nb the bits of N - 1:
//   the low part is the inverted id 0x7fffffff - id without its constant
//   high bits, so every key is distinct, the k-th largest is unique, and
//   (key desc) is exactly (score desc, id asc).
// - Digit passes, 11 bits at a time from the top: a histogram of the keys
//   that share the prefix chosen so far, then the bucket that holds the
//   k-th key.  Keys above it are winners; only the bucket's keys go on.
//   The passes stop as soon as the bucket holds exactly the keys still
//   needed, so they reach the id bits only where score ties span the
//   k-th slot; that is decided on the device.  The winners (at most 128)
//   are sorted once, each placed by the count of winners above it, and
//   written with the float read at their id.
// - `topk_cluster`, one 8-CTA thread-block cluster, selects from up to
//   kOneLaunchMax = 262,144 scores (or from a candidate buffer).  Each
//   CTA keeps its slice of score keys in shared memory.  First a bound:
//   the CTAs read each other's 16 warp maxima through distributed shared
//   memory, and the kk-th largest of the 128 (kk = keys still needed) has
//   at least kk keys at or above it, so keys below it can be dropped.  The
//   rest (tens to hundreds on random scores) go to rank 0, which selects
//   among them alone (`select_in_cta`: up to 128 keys placed at once, more
//   after digit passes).  If more than kGather keys survive (ties), the
//   passes run over the whole cluster instead: each CTA adds its histogram
//   into every CTA's through distributed shared memory, one cluster
//   barrier a pass.  Nothing goes back to global memory between passes.
//   N <= kOneLaunchMax is this one launch.
// - Larger N: a memset of a small state block, then three launches.
//   `topk_hist` reads the scores once (float4, per-CTA shared histograms
//   merged by global atomics; each warp also records the largest score
//   key of each 512-score segment it reads) and its last CTA picks the
//   first bucket.  `topk_filter` reads again only the segments whose
//   largest key reaches that bucket (a few percent on random scores),
//   lists the keys above the bucket and compacts the bucket's keys into a
//   candidate buffer (the caller sizes it for N: five distinct values put
//   N/5 in a bucket); its last CTA selects among them when they fit its
//   shared memory (kFinish keys), else `topk_cluster` selects from the
//   buffer.  Otherwise `topk_cluster` returns at once.
//
// The launch sequence depends on N alone (1, or memset + 3), every
// data-dependent choice is made on the device, and nothing is read back
// by the host, so a call can be captured in a CUDA graph.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Nothing is allocated here; the caller passes the scratch.  Every launch
// is followed by cudaGetLastError(), whose code is returned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 11;
constexpr int kBins = 1 << kDigitBits;             // 2,048
static_assert(kBins == 4 * kThreads, "a thread owns 4 digits in `choose`");
constexpr int kCluster = 8;                        // portable cluster size
constexpr int kSlice = 32768;                      // keys per CTA, 128 KB
constexpr long long kOneLaunchMax = static_cast<long long>(kCluster) * kSlice;
constexpr int kGather = 4096;  // keys rank 0 selects from alone
constexpr int kMaxK = 128;
constexpr int32_t kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
// The streaming kernels: each lane reads kUnroll float4s of a 512-score
// segment at once (about 8 MB in flight over the card, what 3.35 TB/s
// needs to stay busy).
constexpr int kUnroll = 4;
constexpr int kSegVecs = 32 * kUnroll;  // float4s of a segment
constexpr int kStreamCtasPerSm = 2;
constexpr int kFinish = 2048;  // keys `topk_filter`'s last CTA selects from

// The selection so far: the k-th key's top bits are `prefix` (= key >>
// shift); `kk` keys are still needed from among those that share it.
// Once `done`, the winners are exactly the keys with key >> shift >=
// prefix.
struct Select {
  u64 prefix;
  int shift;
  int kk;
  int done;
  int pad;
};

// Global state of the multi-launch path (zeroed before `topk_hist`).
struct State {
  unsigned hist[kBins];   // first pass, summed over CTAs
  unsigned ctas_done;     // `topk_hist`'s last-CTA counter
  unsigned n_win;         // keys in `win`
  unsigned n_buf;         // keys in the candidate buffer
  unsigned filters_done;  // `topk_filter`'s last-CTA counter
  unsigned finished;      // `topk_filter`'s last CTA wrote the result
  unsigned pad;
  Select sel;             // after the first pass
  u64 win[kMaxK];
};

constexpr long long align256(long long bytes) {
  return (bytes + 255) / 256 * 256;
}
constexpr long long kStateBytes = align256(sizeof(State));

struct Pick {
  unsigned digit, above, count;
};

// `topk_cluster`'s larger shared arrays, ahead of the slice of keys in
// dynamic shared memory.
struct ClusterSmem {
  u64 gathered[kGather + kMaxK];  // rank 0: the keys at or above the bound
  unsigned merged[2][kBins];      // whole-cluster passes, double buffered
};

// Order-preserving key of a score; 0 for a non-candidate (-inf), the
// largest key for any NaN.
__device__ __forceinline__ uint32_t score_key(float x) {
  if (x != x) return 0xffffffffu;
  if (x == -INFINITY) return 0u;
  uint32_t u = __float_as_uint(x);
  if (x == 0.0f) u = 0u;  // -0.0 ties with +0.0 and breaks the tie by id
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(uint32_t sk, int nb, uint32_t mask,
                                        uint32_t id) {
  return (static_cast<u64>(sk) << nb) | (mask - id);
}

// One digit pass's bucket choice, by all kThreads threads of a CTA.
// Thread t holds the counts of digits kBins - 1 - (4t + j), j = 0..3 in
// c.x..c.w, highest first.  Returns the updated selection (the same on
// every thread); `pick` and `warp_sums` are shared scratch.  Digits at or
// above 2^(s.shift - lo) hold no keys.
__device__ __noinline__ Select choose(uint4 c, int lo, Select s, Pick& pick,
                                      unsigned* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned cnt[4] = {c.x, c.y, c.z, c.w};
  const unsigned sum = c.x + c.y + c.z + c.w;
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  unsigned above = incl - sum, total = 0;
#pragma unroll
  for (int x = 0; x < kWarps; ++x) {
    const unsigned v = warp_sums[x];
    if (x < wid) above += v;
    total += v;
  }
  const unsigned kk = static_cast<unsigned>(s.kk);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (above < kk && above + cnt[j] >= kk)
      pick = {static_cast<unsigned>(kBins - 1 - (4 * tid + j)), above, cnt[j]};
    above += cnt[j];
  }
  __syncthreads();
  if (total <= kk) {
    s.done = 1;  // no more candidates than needed: they all win
  } else {
    s.prefix = (s.prefix << (s.shift - lo)) | pick.digit;
    s.kk = static_cast<int>(kk - pick.above);
    s.shift = lo;
    s.done = pick.count == kk - pick.above;
  }
  __syncthreads();  // pick and warp_sums are reused
  return s;
}

// This thread's counts for `choose`, read from h and zeroed there.
__device__ __forceinline__ uint4 take_counts(unsigned* h) {
  unsigned* at = h + kBins - 4 - 4 * threadIdx.x;  // digits at[3] .. at[0]
  const uint4 c = make_uint4(at[3], at[2], at[1], at[0]);
  at[0] = at[1] = at[2] = at[3] = 0u;
  return c;
}

// The k largest of the first m keys of `list` (distinct; m <= kMaxK),
// each placed by the count of keys above it, then slots m..k-1 as (-inf,
// sentinel).  One CTA.
__device__ __noinline__ void write_sorted(const u64* list, unsigned m, int k,
                                         const float* scores, uint32_t mask,
                                         float* out_v, int32_t* out_i) {
  const int tid = threadIdx.x;
  if (tid < static_cast<int>(m)) {
    const u64 key = list[tid];
    unsigned place = 0;
    for (unsigned j = 0; j < m; ++j) place += list[j] > key;
    if (place < static_cast<unsigned>(k)) {
      const uint32_t id = mask - (static_cast<uint32_t>(key) & mask);
      out_v[place] = __ldg(scores + id);  // the float itself, -0.0 included
      out_i[place] = static_cast<int32_t>(id);
    }
  }
  for (int r = static_cast<int>(m) + tid; r < k; r += kThreads) {
    out_v[r] = -INFINITY;
    out_i[r] = kSentinel;
  }
}

// Shared memory of a selection that one CTA finishes.
struct CtaScratch {
  unsigned hist[kBins];  // zero between passes
  u64 list[kMaxK];
  unsigned n_list;
  Pick pick;
  unsigned warp_sums[kWarps];
};

// The k best of m distinct keys in shared memory (m <= kGather + kMaxK),
// written out by one CTA: placed at once when m <= kMaxK (each key's
// place costs m compares), else after digit passes from `s` over the
// keys that share its prefix (keys above the prefix are winners already).
// cs.hist must be zero.
__device__ __forceinline__ void select_in_cta(const u64* keys, unsigned m,
                                              Select s, int k,
                                              const float* scores,
                                              uint32_t mask, CtaScratch& cs,
                                              float* out_v, int32_t* out_i) {
  const int tid = threadIdx.x;
  if (m <= static_cast<unsigned>(kMaxK)) {
    write_sorted(keys, m, k, scores, mask, out_v, out_i);
    return;
  }
  if (tid == 0) cs.n_list = 0u;
  __syncthreads();
  while (!s.done) {
    const int lo = max(s.shift - kDigitBits, 0);
    const unsigned dmask = (1u << (s.shift - lo)) - 1u;
    for (unsigned i = tid; i < m; i += kThreads) {
      const u64 key = keys[i];
      if ((key >> s.shift) == s.prefix)
        atomicAdd(&cs.hist[static_cast<unsigned>(key >> lo) & dmask], 1u);
    }
    __syncthreads();
    s = choose(take_counts(cs.hist), lo, s, cs.pick, cs.warp_sums);
  }
  for (unsigned i = tid; i < m; i += kThreads) {
    const u64 key = keys[i];
    if ((key >> s.shift) >= s.prefix) {
      const unsigned slot = atomicAdd(&cs.n_list, 1u);
      if (slot < kMaxK) cs.list[slot] = key;
    }
  }
  __syncthreads();
  write_sorted(cs.list, min(cs.n_list, static_cast<unsigned>(kMaxK)), k,
               scores, mask, out_v, out_i);
}

// ---------------------------------------------------------------------------
// the selection in one cluster
// ---------------------------------------------------------------------------

// Entries a CTA of the cluster takes: a multiple of 4, so each slice of a
// 16-byte aligned score vector is too.
__host__ __device__ __forceinline__ long long slice_of(long long count) {
  return ((count + kCluster - 1) / kCluster + 3) / 4 * 4;
}

// kDirect: the input is the score vector (N <= kOneLaunchMax), every pass
// from the first; else the candidate buffer and winner list that
// `topk_filter` left, from the state after the first pass.
template <bool kDirect>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
topk_cluster(const float* __restrict__ scores, long long n, int nb, int k,
             const State* __restrict__ st, const u64* __restrict__ buf,
             float* __restrict__ out_v, int32_t* __restrict__ out_i) {
  extern __shared__ uint4 dyn_smem[];
  ClusterSmem& sm = *reinterpret_cast<ClusterSmem*>(dyn_smem);
  uint4* slice4 = reinterpret_cast<uint4*>(&sm + 1);
  const uint32_t* slice_keys = reinterpret_cast<const uint32_t*>(slice4);
  __shared__ CtaScratch cs;
  __shared__ u64 wmax_own[kWarps], wmax[kCluster * kWarps];
  __shared__ unsigned n_gathered, gathered_total;
  __shared__ u64 bound;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const uint32_t mask = nb ? (1u << nb) - 1u : 0u;

  Select s;
  long long count;
  if (kDirect) {
    s = {0ull, 32 + nb, k, 0, 0};
    count = n;
  } else {
    if (st->finished) return;  // `topk_filter` wrote the result
    s = st->sel;
    count = st->n_buf;
  }
  const long long per = slice_of(count);
  const long long begin = per * rank;
  const int len = static_cast<int>(
      max(0ll, min(per, count - begin)));  // <= kSlice when kDirect
  for (int i = tid; i < kBins; i += kThreads)
    cs.hist[i] = sm.merged[0][i] = sm.merged[1][i] = 0u;
  if (tid == 0) {
    cs.n_list = n_gathered = 0u;
    bound = 0ull;
  }

  if (kDirect) {
    const float* src = scores + begin;  // 16-byte aligned if scores is
    int i = tid;
    if ((reinterpret_cast<uintptr_t>(scores) & 15u) == 0) {
      for (; 4 * i + 3 < len; i += kThreads) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src) + i);
        slice4[i] = make_uint4(score_key(v.x), score_key(v.y),
                               score_key(v.z), score_key(v.w));
      }
      i = 4 * (len / 4) + tid;
    }
    uint32_t* keys = reinterpret_cast<uint32_t*>(slice4);
    for (; i < len; i += kThreads) keys[i] = score_key(__ldg(src + i));
    __syncthreads();
  }
  // Every key of the slice is a candidate of the current prefix: the
  // direct slice has no prefix yet, the buffer holds one bucket.
  auto key_at = [&](int i, u64& key) -> bool {
    if (kDirect) {
      const uint32_t sk = slice_keys[i];
      key = make_key(sk, nb, mask, static_cast<uint32_t>(begin + i));
      return sk != 0u;
    }
    key = __ldg(buf + begin + i);
    return true;
  };

  // the bound: each warp's largest key, read by every CTA
  u64 top = 0ull;
#pragma unroll 4
  for (int i = tid; i < len; i += kThreads) {
    u64 key;
    if (key_at(i, key)) top = max(top, key);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = max(top, __shfl_xor_sync(kFull, top, off));
  if (lane == 0) wmax_own[wid] = top;
  cluster.sync();  // every CTA has started, set up and found its maxima
  if (tid < kCluster * kWarps)
    wmax[tid] = cluster.map_shared_rank(wmax_own, tid / kWarps)[tid % kWarps];
  __syncthreads();
  // The kk-th largest warp maximum: kk warps hold a key at or above it,
  // so the kk best keys all lie at or above it.  0 if fewer warps hold a
  // candidate.
  {
    static_assert(kThreads == 4 * kCluster * kWarps, "4 threads a maximum");
    // four threads a maximum, each counting every fourth one, so the
    // quarters read neighbouring words, not one bank
    const u64 v = wmax[tid / 4];
    unsigned place = 0;
#pragma unroll
    for (int j = 0; j < kCluster * kWarps / 4; ++j)
      place += wmax[4 * j + tid % 4] > v;
    place += __shfl_xor_sync(kFull, place, 1);
    place += __shfl_xor_sync(kFull, place, 2);
    if (tid % 4 == 0 && v != 0ull &&
        place == static_cast<unsigned>(s.kk - 1))
      bound = v;
  }
  __syncthreads();
  const u64 lb = bound;

  // the keys at or above the bound go to rank 0
  unsigned* gather_n = cluster.map_shared_rank(&n_gathered, 0);
  u64* gather = cluster.map_shared_rank(sm.gathered, 0);
#pragma unroll 4
  for (int i = tid; i < len; i += kThreads) {
    u64 key;
    if (key_at(i, key) && key >= lb) {
      const unsigned slot = atomicAdd(gather_n, 1u);
      if (slot < kGather) gather[slot] = key;
    }
  }
  cluster.sync();
  if (tid == 0) gathered_total = *gather_n;
  __syncthreads();
  const unsigned total = gathered_total;

  if (total <= static_cast<unsigned>(kGather)) {
    // rank 0 alone, over the gathered keys in its shared memory and (from
    // a buffer) the keys `topk_filter` found above the first bucket
    if (rank != 0) return;
    unsigned m = total;
    if (!kDirect) {
      const unsigned nw = min(st->n_win, static_cast<unsigned>(kMaxK));
      for (unsigned i = tid; i < nw; i += kThreads)
        sm.gathered[total + i] = st->win[i];
      m += nw;
    }
    __syncthreads();
    select_in_cta(sm.gathered, m, s, k, scores, mask, cs, out_v, out_i);
    return;
  }

  // Too many keys at the bound (ties): passes over the whole cluster.
  // Each CTA adds its counts into every CTA's merged histogram, so one
  // barrier a pass; double buffering keeps a fast CTA's next pass off
  // the counts a slow one still reads.
  unsigned* merged[kCluster];
  for (int p = 0; !s.done; ++p) {
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      merged[r] = cluster.map_shared_rank(sm.merged[p & 1], r);
    const int lo = max(s.shift - kDigitBits, 0);
    const unsigned dmask = (1u << (s.shift - lo)) - 1u;
    for (int i = tid; i < len; i += kThreads) {
      u64 key;
      if (key_at(i, key) && key >= lb && (key >> s.shift) == s.prefix)
        atomicAdd(&cs.hist[static_cast<unsigned>(key >> lo) & dmask], 1u);
    }
    __syncthreads();
    for (int i = tid; i < kBins; i += kThreads) {
      const unsigned v = cs.hist[i];
      if (v) {
        cs.hist[i] = 0u;
#pragma unroll
        for (int r = 0; r < kCluster; ++r) atomicAdd(merged[r] + i, v);
      }
    }
    cluster.sync();
    s = choose(take_counts(sm.merged[p & 1]), lo, s, cs.pick, cs.warp_sums);
  }
  unsigned* list_n = cluster.map_shared_rank(&cs.n_list, 0);
  u64* list0 = cluster.map_shared_rank(cs.list, 0);
  for (int i = tid; i < len; i += kThreads) {
    u64 key;
    if (key_at(i, key) && key >= lb && (key >> s.shift) >= s.prefix) {
      const unsigned slot = atomicAdd(list_n, 1u);
      if (slot < kMaxK) list0[slot] = key;
    }
  }
  cluster.sync();  // after this no CTA touches another's shared memory
  if (rank != 0) return;

  unsigned m = min(cs.n_list, static_cast<unsigned>(kMaxK));
  if (!kDirect) {  // the keys `topk_filter` found above the first bucket
    const unsigned nw = min(st->n_win, kMaxK - m);
    for (unsigned i = tid; i < nw; i += kThreads) cs.list[m + i] = st->win[i];
    m += nw;
  }
  __syncthreads();
  write_sorted(cs.list, m, k, scores, mask, out_v, out_i);
}

// ---------------------------------------------------------------------------
// the multi-launch path's two reads
// ---------------------------------------------------------------------------

// Scores as float4 when the vector is 16-byte aligned (kVec), else one at
// a time; the N % 4 scores past the last float4 are the tail.
template <bool kVec>
__device__ __forceinline__ void load4(const float* scores, long long v,
                                      float (&x)[4]) {
  if (kVec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(scores) + v);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __ldg(scores + 4 * v + j);
  }
}

// One lane's part of a 512-score segment: float4s seg * 128 + u * 32 +
// lane, coalesced across the warp; -inf past the last float4.
template <bool kVec>
__device__ __forceinline__ void load_segment(const float* scores,
                                             long long vecs, long long seg,
                                             int lane,
                                             float (&x)[kUnroll][4]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long v = seg * kSegVecs + u * 32 + lane;
    if (v < vecs) {
      load4<kVec>(scores, v, x[u]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[u][j] = -INFINITY;
    }
  }
}

// First pass over every score: the top kDigitBits bits of the key are
// those of the score key.  Each warp reads whole segments and records
// each one's largest score key.  The last CTA to finish chooses the
// bucket.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
topk_hist(const float* __restrict__ scores, long long n, int nb, int k,
          State* __restrict__ st, uint32_t* __restrict__ seg_max) {
  __shared__ unsigned h[kBins];
  __shared__ Pick pick;
  __shared__ unsigned warp_sums[kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  for (int i = tid; i < kBins; i += kThreads) h[i] = 0u;
  __syncthreads();
  const long long vecs = n / 4;
  const long long segs = (vecs + kSegVecs - 1) / kSegVecs;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long seg = static_cast<long long>(blockIdx.x) * kWarps + wid;
       seg < segs; seg += warps) {
    float x[kUnroll][4];
    load_segment<kVec>(scores, vecs, seg, lane, x);
    uint32_t top = 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sk = score_key(x[u][j]);
        top = max(top, sk);
        if (sk) atomicAdd(&h[sk >> (32 - kDigitBits)], 1u);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      top = max(top, __shfl_xor_sync(kFull, top, off));
    if (lane == 0) seg_max[seg] = top;
  }
  if (blockIdx.x == 0 && tid < n - 4 * vecs) {
    const uint32_t sk = score_key(__ldg(scores + 4 * vecs + tid));
    if (sk) atomicAdd(&h[sk >> (32 - kDigitBits)], 1u);
  }
  __syncthreads();
  for (int i = tid; i < kBins; i += kThreads)
    if (h[i]) atomicAdd(&st->hist[i], h[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&st->ctas_done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned* at = st->hist + kBins - 4 - 4 * tid;
  const uint4 c = make_uint4(__ldcg(at + 3), __ldcg(at + 2), __ldcg(at + 1),
                             __ldcg(at));
  const Select s = choose(c, 32 + nb - kDigitBits, {0ull, 32 + nb, k, 0, 0},
                          pick, warp_sums);
  if (tid == 0) st->sel = s;
}

// Second pass, over the segments whose largest score key reaches the
// first bucket: keys above the bucket (or, when the first pass settled
// it, every winner) go to the winner list; the bucket's keys go to the
// candidate buffer, one atomic per warp and segment.  The tests are on
// the score key alone: the first pass chose among its top kDigitBits bits.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
topk_filter(const float* __restrict__ scores, long long n, int nb, int k,
            State* __restrict__ st, const uint32_t* __restrict__ seg_max,
            u64* __restrict__ buf, float* __restrict__ out_v,
            int32_t* __restrict__ out_i) {
  __shared__ u64 keys[kFinish];  // the last CTA's selection
  __shared__ bool last;
  __shared__ CtaScratch cs;
  const Select s = st->sel;
  const uint32_t mask = nb ? (1u << nb) - 1u : 0u;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  for (int i = tid; i < kBins; i += kThreads) cs.hist[i] = 0u;
  const long long vecs = n / 4;
  const long long segs = (vecs + kSegVecs - 1) / kSegVecs;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  // every candidate wins (no more of them than k), else the score key's
  // top digit against the bucket's
  const bool all = s.shift == 32 + nb;
  const uint32_t bucket = static_cast<uint32_t>(s.prefix);

  // 0: neither, 1: winner, 2: candidate
  auto classify = [&](uint32_t sk) -> int {
    if (!sk) return 0;
    if (all) return 1;
    const uint32_t top = sk >> (32 - kDigitBits);
    if (top > bucket || (s.done && top == bucket)) return 1;
    return top == bucket ? 2 : 0;
  };
  auto win = [&](uint32_t sk, long long id) {
    const unsigned slot = atomicAdd(&st->n_win, 1u);
    if (slot < kMaxK)
      st->win[slot] = make_key(sk, nb, mask, static_cast<uint32_t>(id));
  };
  // One segment (its four float4s a lane loaded at once): winners listed,
  // candidates appended in one warp atomic.
  auto filter = [&](long long seg) {
    float x[kUnroll][4];
    load_segment<kVec>(scores, vecs, seg, lane, x);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = seg * kSegVecs + u * 32 + lane;
      uint32_t sk[4];
      unsigned mine = 0;  // this lane's candidates
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sk[j] = score_key(x[u][j]);
        const int cls = classify(sk[j]);
        if (cls == 1) win(sk[j], 4 * v + j);
        mine += cls == 2;
      }
      if (!__any_sync(kFull, mine)) continue;
      unsigned incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      unsigned base = 0;
      if (lane == 31) base = atomicAdd(&st->n_buf, incl);
      base = __shfl_sync(kFull, base, 31) + incl - mine;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (classify(sk[j]) == 2)
          buf[base++] =
              make_key(sk[j], nb, mask, static_cast<uint32_t>(4 * v + j));
    }
  };
  // Back to front: the first pass's last segments may still be in L2.
  // Lane l reads the maximum of the warp's l-th segment of a round of 32,
  // so one load serves 32 segments, and the warp reads only those whose
  // maximum reaches the bucket.
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + wid;
  for (long long round = 0; first + round * warps < segs; round += 32) {
    const long long mine_seg = segs - 1 - (first + (round + lane) * warps);
    const bool live = mine_seg >= 0 && classify(seg_max[mine_seg]) != 0;
    for (unsigned live_lanes = __ballot_sync(kFull, live); live_lanes;
         live_lanes &= live_lanes - 1)
      filter(__shfl_sync(kFull, mine_seg, __ffs(live_lanes) - 1));
  }
  if (blockIdx.x == 0 && tid < n - 4 * vecs) {
    const long long id = 4 * vecs + tid;
    const uint32_t sk = score_key(__ldg(scores + id));
    const int cls = classify(sk);
    if (cls == 1) win(sk, id);
    if (cls == 2)
      buf[atomicAdd(&st->n_buf, 1u)] =
          make_key(sk, nb, mask, static_cast<uint32_t>(id));
  }
  // The last CTA to finish: when the candidates and the winners fit its
  // shared memory (as on random scores), it selects among them itself and
  // leaves `topk_cluster` nothing to do.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&st->filters_done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned nbuf = __ldcg(&st->n_buf);
  const unsigned nwin = min(__ldcg(&st->n_win), static_cast<unsigned>(kMaxK));
  if (nbuf + nwin > static_cast<unsigned>(kFinish)) return;
  for (unsigned i = tid; i < nbuf; i += kThreads) keys[i] = __ldcg(buf + i);
  for (unsigned i = tid; i < nwin; i += kThreads)
    keys[nbuf + i] = __ldcg(st->win + i);
  __syncthreads();
  select_in_cta(keys, nbuf + nwin, s, k, scores, mask, cs, out_v, out_i);
  if (tid == 0) st->finished = 1u;
}

int id_bits(long long n) {
  int nb = 0;
  while ((1ll << nb) < n) ++nb;  // bits of n - 1
  return nb;
}

long long segments_of(long long n) {
  return (n / 4 + kSegVecs - 1) / kSegVecs;
}

struct DeviceSetup {
  bool ready = false;
  int sms = 0;
};
DeviceSetup g_setup[64];

// Once per device: the SM count, and the cluster kernel's shared memory
// caps.  Neither is a stream operation.
cudaError_t setup(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  DeviceSetup& d = g_setup[dev];
  if (!d.ready) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int direct = static_cast<int>(sizeof(ClusterSmem)) +
                       kSlice * static_cast<int>(sizeof(uint32_t));
    err = cudaFuncSetAttribute(topk_cluster<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               direct);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(topk_cluster<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(ClusterSmem)));
    if (err != cudaSuccess) return err;
    d.ready = true;
  }
  *sms = d.sms;
  return cudaSuccess;
}

template <bool kVec>
cudaError_t launch_stream(const float* scores, long long n, int nb, int k,
                          State* st, uint32_t* seg_max, u64* buf,
                          float* out_v, int32_t* out_i, int sms,
                          cudaStream_t s) {
  const long long want = (segments_of(n) + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(std::max(
      1ll, std::min(want, static_cast<long long>(sms) * kStreamCtasPerSm)));
  topk_hist<kVec><<<grid, kThreads, 0, s>>>(scores, n, nb, k, st, seg_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_filter<kVec><<<grid, kThreads, 0, s>>>(scores, n, nb, k, st, seg_max,
                                              buf, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch bytes a call at this N needs (0: the one-launch path): the
// state, the segment maxima and a candidate buffer of N keys.
long long topk_scratch_bytes(long long n) {
  if (n <= kOneLaunchMax) return 0;
  return kStateBytes + align256(segments_of(n) * 4) +
         n * static_cast<long long>(sizeof(u64));
}

// Kernel launches (besides the memset) of a call at this N.
int topk_kernels_for(long long n) { return n <= kOneLaunchMax ? 1 : 3; }

// Returns a cudaError_t code (0 = ok).
int topk_launch(const float* scores, long long n, int k, void* scratch,
                float* out_v, int32_t* out_i, void* stream) {
  if (n < 1 || n >= kSentinel || k < 1 || k > kMaxK || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t err = setup(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = id_bits(n);
  if (n <= kOneLaunchMax) {
    const size_t smem = sizeof(ClusterSmem) +
                        static_cast<size_t>(slice_of(n)) * sizeof(uint32_t);
    topk_cluster<true><<<kCluster, kThreads, smem, s>>>(
        scores, n, nb, k, nullptr, nullptr, out_v, out_i);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  State* st = reinterpret_cast<State*>(base);
  uint32_t* seg_max = reinterpret_cast<uint32_t*>(base + kStateBytes);
  u64* buf = reinterpret_cast<u64*>(base + kStateBytes +
                                    align256(segments_of(n) * 4));
  err = cudaMemsetAsync(st, 0, sizeof(State), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = (reinterpret_cast<uintptr_t>(scores) & 15u) == 0
            ? launch_stream<true>(scores, n, nb, k, st, seg_max, buf, out_v,
                                  out_i, sms, s)
            : launch_stream<false>(scores, n, nb, k, st, seg_max, buf, out_v,
                                   out_i, sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_cluster<false><<<kCluster, kThreads, sizeof(ClusterSmem), s>>>(
      scores, n, nb, k, st, buf, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

const char* topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
