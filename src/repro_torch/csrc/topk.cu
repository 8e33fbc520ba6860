// Streaming top-k of a score vector for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `top_k_pallas`
// (src/repro/kernels/topk/topk.py, body `_topk_kernel`).  For scores [N]
// f32 and k <= min(N, 128) it returns the k best (value, id) pairs ordered
// (score desc, id asc).  A -inf score is not a candidate: slots that no
// finite (or +inf) score fills come out (-inf, 2^31 - 1), which is what
// the TPU kernel gives whenever its sequential carry starts such a slot
// from its (-inf, sentinel) scratch.  NaN scores are dropped the same way
// (outside the contract: the TPU kernel ranks them first).
//
// What bounds it.  The kernel reads each score once and writes 8k bytes.
// At N = 65,536 that is 256 KB (0.08 us at 3.35 TB/s), so a call is bound
// by launch latency; at N = 16,777,216 it is 64 MB, more than the 50 MB L2,
// 0.020 ms.  The work per score is a few compares per round, k rounds.
//
// The TPU kernel walked the score blocks in order with one VMEM carry and
// relied on that order for its tie rule.  Here CTAs run in any order, so
// the tie rule lives in the comparator alone:
//
// - `topk_tiles`: one CTA of 256 threads owns a tile of 4,096 entries (16
//   per thread, in registers, loaded coalesced).  It runs k rounds; each
//   round picks the best entry strictly worse than the previous pick under
//   (score desc, id asc): a thread scan, a warp shuffle reduction, and
//   every thread reducing the 8 warp winners from shared memory (double
//   buffered, so one barrier per round).  The tile's k picks go out as
//   (value, id) pairs, unfilled slots as (-inf, sentinel).
// - The launcher applies the same kernel to the [tiles * k] candidates,
//   carrying their ids, until one tile remains; that last launch writes
//   the result.  Each level shrinks the list by 4,096 / k (>= 32).
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Nothing is allocated here; the caller passes the scratch.  Every launch
// is followed by cudaGetLastError(), whose code is returned.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // 4,096 entries per CTA
constexpr int kMaxK = 128;
constexpr int32_t kSentinel = 0x7fffffff;

// (av, ai) ranks strictly before (bv, bi): score desc, then id asc.
__device__ __forceinline__ bool better(float av, int32_t ai, float bv,
                                       int32_t bi) {
  return av > bv || (av == bv && ai < bi);
}

// Warp-wide best (v, i); every lane ends with the winner.
__device__ __forceinline__ void warp_best(float& v, int32_t& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int32_t oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// kIds: the entries carry ids (a later level); else an entry's id is its
// position in `vals`.
template <bool kIds>
__global__ void __launch_bounds__(kThreads)
topk_tiles(const float* __restrict__ vals, const int32_t* __restrict__ ids,
           long long n, int k, float* __restrict__ out_v,
           int32_t* __restrict__ out_i) {
  __shared__ float wv[2][kWarps];
  __shared__ int32_t wi[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;

  float v[kPerThread];
  int32_t id[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long p = base + static_cast<long long>(j) * kThreads + tid;
    v[j] = -INFINITY;
    id[j] = kSentinel;
    if (p < n) {
      v[j] = __ldg(vals + p);
      id[j] = kIds ? __ldg(ids + p) : static_cast<int32_t>(p);
    }
    if (!(v[j] > -INFINITY)) id[j] = kSentinel;  // -inf, NaN: no candidate
  }

  float* ov = out_v + static_cast<size_t>(blockIdx.x) * k;
  int32_t* oi = out_i + static_cast<size_t>(blockIdx.x) * k;
  float last_v = INFINITY;
  int32_t last_i = -1;
  int t = 0;
  for (; t < k; ++t) {
    float bv = -INFINITY;
    int32_t bi = kSentinel;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (id[j] != kSentinel && better(last_v, last_i, v[j], id[j]) &&
          better(v[j], id[j], bv, bi)) {
        bv = v[j];
        bi = id[j];
      }
    warp_best(bv, bi);
    const int buf = t & 1;
    if (lane == 0) {
      wv[buf][wid] = bv;
      wi[buf][wid] = bi;
    }
    __syncthreads();
    bv = wv[buf][0];
    bi = wi[buf][0];
#pragma unroll
    for (int x = 1; x < kWarps; ++x)
      if (better(wv[buf][x], wi[buf][x], bv, bi)) {
        bv = wv[buf][x];
        bi = wi[buf][x];
      }
    if (bi == kSentinel) break;  // nothing left; every thread agrees
    if (tid == 0) {
      ov[t] = bv;
      oi[t] = bi;
    }
    last_v = bv;
    last_i = bi;
  }
  for (int r = t + tid; r < k; r += kThreads) {
    ov[r] = -INFINITY;
    oi[r] = kSentinel;
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// Tiles of the first level: the scratch holds 2 * tiles * k candidates
// when tiles > 1 (none is read for a single tile).
long long topk_tiles_for(long long n) { return tiles_of(n); }

int topk_max_k() { return kMaxK; }

// Returns a cudaError_t code (0 = ok).
int topk_launch(const float* scores, long long n, int k, float* scratch_v,
                int32_t* scratch_i, float* out_v, int32_t* out_i,
                void* stream) {
  if (n < 1 || n >= kSentinel || k < 1 || k > kMaxK || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long half = tiles_of(n) * k;  // one scratch buffer
  const float* in_v = scores;
  const int32_t* in_i = nullptr;
  long long m = n;
  for (int level = 0;; ++level) {
    const long long tiles = tiles_of(m);
    float* dv = out_v;
    int32_t* di = out_i;
    if (tiles > 1) {  // levels alternate between the two scratch buffers
      dv = scratch_v + (level & 1) * half;
      di = scratch_i + (level & 1) * half;
    }
    if (in_i == nullptr)
      topk_tiles<false><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          in_v, nullptr, m, k, dv, di);
    else
      topk_tiles<true><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          in_v, in_i, m, k, dv, di);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
    in_v = dv;
    in_i = di;
    m = tiles * k;
  }
}

const char* topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
