// The decode step's GQA attention core for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes decode attention in
// plain jnp (`src/repro/models/transformer.py::_layer_decode`,
// `models/attention.py::decode_attention`), and the port did the same in
// plain PyTorch.  It was added because that plain form is most of a
// decode step's kernels: per layer about 76 small launches (qk-norm,
// RoPE with its sin/cos table, the cache write, the softmax chain) and
// float32 copies of the whole bf16 cache, the grouped query's broadcast
// materialised once for K and once for V, so a qwen3-moe token moved
// more bytes in those copies than it read in weights.  One token of one
// sequence, after the q/k/v projections, as the plain path computes it:
//
//   q, k_new  <- RMSNorm per head in f32 (gain 1 + w, eps), to bf16
//                (skipped for a model without qk-norm)
//   q, k_new  <- split-half RoPE at position length - 1, in f32, to bf16
//   cache[(length - 1) % S] <- k_new, v_new
//   o         <- softmax(scale · q·K^T over slots < length) · V
//                (f32 scores, max, exp and sum; p rounded to bf16 before
//                 P·V; f32 accumulation), to bf16
//
// What bounds it.  It reads the layer's bf16 cache once: for qwen3-moe
// at 2,056 slots, 4 kv heads of 128, that is 4.2 MB, 1.25 us at 3.35
// TB/s; its arithmetic (2 · Hq · fill · Dh · 2 flops) is ~0.5 flop a
// byte.  At one token the cache is small next to the card, so the design
// is about keeping enough of it in flight at once:
//
// - Grid (splits, Hkv, B): a CTA owns one kv head's slice of the filled
//   slots and serves all G = Hq / Hkv query heads from each K/V row it
//   loads (GQA's reuse; the plain path re-read the rows per query head).
//   The wrapper sizes the splits from the cache length and the SM count
//   so that about two CTAs an SM each stream one or a few 64-row tiles;
//   the fill, read on the device, sets each split's rows, so one launch
//   serves every fill and a CUDA graph replays it unchanged.
// - Rows arrive by 16-byte cp.async, K and V of the next tile while the
//   current one is used (two stages).  Scores: a half-warp covers one
//   row (8 dims a lane, q's G heads in registers) and reduces by
//   shuffles; softmax a warp per head; P·V a thread per dim.
// - Every CTA normalises and rotates q and k_new itself (a few hundred
//   values); the first split writes k_new and v_new into the cache, and
//   any CTA whose tile holds that slot puts the fresh row into its tile
//   in place of what it loaded, so no CTA waits on another's write.
// - The splits' (max, sum, unnormalised o) go to a float32 scratch; a
//   second launch, one CTA per query head, merges them in split order.
//   Each output has one fixed order of operations: the same inputs give
//   the same bits on every run, eager or replayed.  Both launches are
//   programmatic (they may be set up while the kernel before them
//   drains) and wait for it before they touch memory.
//
// Rounding follows the plain path: the norm's and RoPE's products and
// sums round to f32 one operation at a time (no FMA contraction), to
// bf16 where it rounds.  The softmax is online across tiles and splits,
// so p is rounded to bf16 relative to its tile's running max rather than
// the global one (flash attention's rounding).
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Nothing is allocated here; each launch is followed by
// cudaGetLastError(), whose code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kDh = 128;        // the head size of the design
constexpr int kThreads = 128;   // four warps; one thread per dim in P·V
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // cache rows a CTA stages at a time
constexpr int kMaxG = 8;        // query heads per kv head
constexpr float kMask = -1e30f;  // models/attention.py's MASK_VALUE
static_assert(kThreads == kDh, "P.V and the append give a thread a dim");

struct Params {
  const uint16_t* q;      // [B, Hq, 1, Dh] bf16, by (batch, head) strides
  const uint16_t* k_new;  // [B, Hkv, 1, Dh]
  const uint16_t* v_new;
  uint16_t* k_cache;      // [B, Hkv, S, Dh], rows 16-byte aligned
  uint16_t* v_cache;
  const float* q_norm;    // [Dh] f32 gains, or null (no qk-norm)
  const float* k_norm;
  const int32_t* lengths;  // [B] cache fill including this token
  float* part_o;          // [B, Hq, splits, Dh] unnormalised outputs
  float* part_ml;         // [B, Hq, splits, 2] running max and sum
  uint16_t* out;          // [B, Hq, 1, Dh] contiguous
  long long q_sb, q_sh, kn_sb, kn_sh, vn_sb, vn_sh;
  long long kc_sb, kc_sh, kc_sr, vc_sb, vc_sh, vc_sr;
  int hq, hkv, s_max, splits;
  float scale, rope_base, eps;
};

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint16_t f32_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_bf16(float x) {
  return bf16_bits_to_f32(f32_to_bf16_bits(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Lane l's RoPE factors at position pos: (sin, cos) of its two
// frequencies, dims l and l + 32 (layers.rope_table's f32 steps).
__device__ __forceinline__ void rope_factors(float pos, float base, int lane,
                                             float* sn, float* cs) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = lane + 32 * j;  // < Dh / 2
    const float freq = powf(base, -static_cast<float>(d) / (kDh / 2));
    const float angle = __fmul_rn(pos, freq);
    sn[j] = sinf(angle);
    cs[j] = cosf(angle);
  }
}

// One head vector x (lane l holds dims l, l + 32, l + 64, l + 96, so
// RoPE's pairs (d, d + 64) meet in one lane) normalised (when gain is
// not null) and rotated by one warp, written to dst as the bf16 values
// it rounds to, widened to f32.
__device__ __forceinline__ void norm_rope(float* x, const float* gain,
                                          float eps, const float* sn,
                                          const float* cs, float* dst,
                                          int lane) {
  if (gain != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) ss = __fadd_rn(ss, __fmul_rn(x[i], x[i]));
    const float var = __fmul_rn(warp_sum(ss), 1.f / kDh);
    const float r = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = round_bf16(__fmul_rn(__fmul_rn(x[i], r),
                                  __fadd_rn(1.f, gain[lane + 32 * i])));
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = lane + 32 * j;
    const float x1 = x[j], x2 = x[j + 2];
    dst[d] = round_bf16(__fsub_rn(__fmul_rn(x1, cs[j]), __fmul_rn(x2, sn[j])));
    dst[d + kDh / 2] =
        round_bf16(__fadd_rn(__fmul_rn(x2, cs[j]), __fmul_rn(x1, sn[j])));
  }
}

// Waits for the kernel before this one in the stream to finish and its
// writes to be visible (a no-op without a programmatic launch).
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Rows [lo, lo + n) of one kv head's K and V into a stage (zero rows past
// n): 16 16-byte pieces a row, kThreads pieces a round.
__device__ __forceinline__ void stage_tile(uint16_t* ks, uint16_t* vs,
                                           const uint16_t* kc,
                                           const uint16_t* vc, long long k_sr,
                                           long long v_sr, int lo, int n) {
  constexpr int kPieces = kDh / 8;
  for (int i = threadIdx.x; i < kTile * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    const bool valid = r < n;
    const long long row = valid ? lo + r : 0;
    hopper::cp_async16(ks + r * kDh + c, kc + row * k_sr + c, valid);
    hopper::cp_async16(vs + r * kDh + c, vc + row * v_sr + c, valid);
  }
  hopper::cp_async_commit();
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    decode_split(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem_raw);  // [2][kTile][kDh]
  uint16_t* vs = ks + 2 * kTile * kDh;                    // [2][kTile][kDh]
  float* qs = reinterpret_cast<float*>(vs + 2 * kTile * kDh);  // [G][kDh]
  float* kn = qs + G * kDh;                                // [kDh]
  float* vn = kn + kDh;                                    // [kDh]
  float* sc = vn + kDh;       // [G][kTile] scores, then bf16-rounded p
  float* m_run = sc + G * kTile;  // [G]
  float* l_run = m_run + G;       // [G]
  float* alpha = l_run + G;       // [G]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // everything read below may come from the kernel just before this one
  // (the fill from a cast, q, k_new and v_new from the projections), and
  // the scratch written may have been its memory
  wait_for_previous_kernel();
  const int len = p.lengths[b];
  const int n = min(max(len, 0), p.s_max);  // slots < length
  int new_slot = (len - 1) % p.s_max;
  if (new_slot < 0) new_slot += p.s_max;
  const int chunk = (n + p.splits - 1) / p.splits;
  const int start = min(split * chunk, n), end = min(start + chunk, n);

  const long long part = (static_cast<long long>(b) * p.hq + h * G) *
                         p.splits + split;  // query head h * G's entry
  if (start >= end && split != 0) {  // nothing to attend, nothing to write
    for (int i = tid; i < G * kDh; i += kThreads)
      p.part_o[(part + static_cast<long long>(i / kDh) * p.splits) * kDh +
               i % kDh] = 0.f;
    if (tid < G) {
      p.part_ml[(part + static_cast<long long>(tid) * p.splits) * 2] = kMask;
      p.part_ml[(part + static_cast<long long>(tid) * p.splits) * 2 + 1] = 0.f;
    }
    return;
  }

  const uint16_t* kc = p.k_cache + b * p.kc_sb + h * p.kc_sh;
  const uint16_t* vc = p.v_cache + b * p.vc_sb + h * p.vc_sh;
  const int n_tiles = (end - start + kTile - 1) / kTile;
  if (n_tiles > 0)  // the first tile's loads overlap the rotations
    stage_tile(ks, vs, kc, vc, p.kc_sr, p.vc_sr, start,
               min(kTile, end - start));

  constexpr int kVecs = (G + 1 + kWarps - 1) / kWarps;  // vectors a warp
  float x[kVecs][4];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int vec = warp + j * kWarps;
    const uint16_t* src =
        vec < G ? p.q + b * p.q_sb + (h * G + vec) * p.q_sh
                : p.k_new + b * p.kn_sb + h * p.kn_sh;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[j][i] = vec <= G ? bf16_bits_to_f32(src[lane + 32 * i]) : 0.f;
  }
  vn[tid] = bf16_bits_to_f32(p.v_new[b * p.vn_sb + h * p.vn_sh + tid]);
  float sn[2], cs[2];
  rope_factors(static_cast<float>(len - 1), p.rope_base, lane, sn, cs);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int vec = warp + j * kWarps;
    if (vec < G)
      norm_rope(x[j], p.q_norm, p.eps, sn, cs, qs + vec * kDh, lane);
    else if (vec == G)
      norm_rope(x[j], p.k_norm, p.eps, sn, cs, kn, lane);
  }
  if (tid < G) {
    m_run[tid] = kMask;
    l_run[tid] = 0.f;
  }
  __syncthreads();
  if (split == 0) {  // the append; readers of the slot use kn, vn instead
    uint16_t* kdst = p.k_cache + b * p.kc_sb + h * p.kc_sh +
                     static_cast<long long>(new_slot) * p.kc_sr;
    uint16_t* vdst = p.v_cache + b * p.vc_sb + h * p.vc_sh +
                     static_cast<long long>(new_slot) * p.vc_sr;
    kdst[tid] = f32_to_bf16_bits(kn[tid]);
    vdst[tid] = f32_to_bf16_bits(vn[tid]);
  }

  // q's G heads, the 8 dims this lane covers in the score products
  const int half = lane / 16, d0 = (lane % 16) * 8;
  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[g][e] = qs[g * kDh + d0 + e];
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int lo = start + t * kTile, rows = min(kTile, end - lo);
    uint16_t* kt = ks + (t & 1) * kTile * kDh;
    uint16_t* vt = vs + (t & 1) * kTile * kDh;
    if (t + 1 < n_tiles) {
      const int lo1 = lo + kTile;
      stage_tile(ks + ((t + 1) & 1) * kTile * kDh,
                 vs + ((t + 1) & 1) * kTile * kDh, kc, vc, p.kc_sr, p.vc_sr,
                 lo1, min(kTile, end - lo1));
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    if (new_slot >= lo && new_slot < lo + rows) {
      kt[(new_slot - lo) * kDh + tid] = f32_to_bf16_bits(kn[tid]);
      vt[(new_slot - lo) * kDh + tid] = f32_to_bf16_bits(vn[tid]);
      __syncthreads();
    }

    // scores: warp w takes rows w * 16 .. w * 16 + 15, two at a time
#pragma unroll
    for (int i = 0; i < kTile / kWarps / 2; ++i) {
      const int r = warp * (kTile / kWarps) + 2 * i + half;
      const uint4 raw = *reinterpret_cast<const uint4*>(kt + r * kDh + d0);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float kv[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kv[2 * e] = __uint_as_float(words[e] << 16);
        kv[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
      }
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qr[g][e], kv[e], s);
        dot[g] = s;
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          dot[g] = __fadd_rn(dot[g], __shfl_xor_sync(0xffffffffu, dot[g], off));
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (lane % 16 == g && r < rows)
          sc[g * kTile + r] = __fmul_rn(dot[g], p.scale);
    }
    __syncthreads();

    // online softmax: warp w takes heads w, w + 4; lanes rows l, l + 32
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = lane < rows ? sc[g * kTile + lane] : kMask;
      const float s1 = lane + 32 < rows ? sc[g * kTile + lane + 32] : kMask;
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < rows ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < rows ? expf(s1 - m_new) : 0.f;
      const float sum = warp_sum(__fadd_rn(p0, p1));
      sc[g * kTile + lane] = round_bf16(p0);
      sc[g * kTile + lane + 32] = round_bf16(p1);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[g] = a;
        l_run[g] = __fadd_rn(__fmul_rn(l_run[g], a), sum);
        m_run[g] = m_new;
      }
    }
    __syncthreads();

    // P·V: thread tid owns dim tid of every head.  Rows past `rows` add
    // nothing: their p is 0 and their V row was zero-filled
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = __fmul_rn(acc[g], alpha[g]);
#pragma unroll 2
    for (int r = 0; r < kTile; r += 4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = bf16_bits_to_f32(vt[(r + e) * kDh + tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 pg = *reinterpret_cast<const float4*>(sc + g * kTile + r);
        acc[g] = fmaf(pg.x, v[0], acc[g]);
        acc[g] = fmaf(pg.y, v[1], acc[g]);
        acc[g] = fmaf(pg.z, v[2], acc[g]);
        acc[g] = fmaf(pg.w, v[3], acc[g]);
      }
    }
    __syncthreads();  // the stage and the scores are reused next tile
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
    p.part_o[(part + static_cast<long long>(g) * p.splits) * kDh + tid] =
        acc[g];
  if (tid < G) {
    p.part_ml[(part + static_cast<long long>(tid) * p.splits) * 2] =
        m_run[tid];
    p.part_ml[(part + static_cast<long long>(tid) * p.splits) * 2 + 1] =
        l_run[tid];
  }
}

// One CTA a (query head, batch row), one thread a dim: the splits'
// partial results rescaled to their common max and summed in split order.
__global__ void __launch_bounds__(kThreads)
    decode_merge(const __grid_constant__ Params p) {
  extern __shared__ float w[];  // [splits] weights, then [splits] sums
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long base = (static_cast<long long>(b) * p.hq + hq) * p.splits;
  const float* ml = p.part_ml + base * 2;
  wait_for_previous_kernel();
  for (int i = d; i < p.splits; i += kThreads) {
    w[i] = ml[2 * i];
    w[p.splits + i] = ml[2 * i + 1];
  }
  __syncthreads();
  float m = kMask;
  for (int i = 0; i < p.splits; ++i) m = fmaxf(m, w[i]);
  __syncthreads();
  for (int i = d; i < p.splits; i += kThreads) w[i] = expf(w[i] - m);
  __syncthreads();
  float l = 0.f, o = 0.f;
#pragma unroll 4
  for (int i = 0; i < p.splits; ++i) {
    l = __fadd_rn(l, __fmul_rn(w[p.splits + i], w[i]));
    o = __fadd_rn(o, __fmul_rn(p.part_o[(base + i) * kDh + d], w[i]));
  }
  p.out[(static_cast<long long>(b) * p.hq + hq) * kDh + d] =
      f32_to_bf16_bits(__fdiv_rn(o, l == 0.f ? 1.f : l));
}

// A launch that may start while the kernel before it in the stream
// finishes (programmatic dependent launch); the kernel waits for it
// (wait_for_previous_kernel) before it reads what that kernel wrote.
template <typename Kernel>
cudaError_t launch_after(Kernel kernel, dim3 grid, size_t smem,
                         cudaStream_t s, const Params& p) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

constexpr size_t smem_bytes(int g) {
  return 4 * kTile * kDh * sizeof(uint16_t) +
         (g * kDh + 2 * kDh + g * kTile + 3 * g) * sizeof(float);
}

template <int G>
int launch_g(int b, const Params& p, cudaStream_t s) {
  const size_t smem = smem_bytes(G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_after(decode_split<G>, dim3(p.splits, p.hkv, b), smem, s, p);
  if (err == cudaSuccess)
    err = launch_after(decode_merge, dim3(p.hq, b),
                       2 * p.splits * sizeof(float), s, p);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// The q/k_new/v_new strides (elements) are (batch, head); the caches'
// (batch, head, row).  Each row is Dh contiguous elements.  q_norm and
// k_norm are both null or both set.  Returns a cudaError_t code.
int decode_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, const void* q_norm, const void* k_norm,
    const void* lengths, void* part_o, void* part_ml, void* out, int b,
    int hq, int hkv, int s_max, int dh, int splits, long long q_sb,
    long long q_sh, long long kn_sb, long long kn_sh, long long vn_sb,
    long long vn_sh, long long kc_sb, long long kc_sh, long long kc_sr,
    long long vc_sb, long long vc_sh, long long vc_sr, float scale,
    float rope_base, float eps, void* stream) {
  if (dh != kDh || b < 1 || b > 65535 || hkv < 1 || hkv > 65535 ||
      hq % hkv != 0 || hq / hkv > kMaxG || s_max < 1 || splits < 1 ||
      splits > 4096 ||  // the merge's weights fit its shared memory
      (q_norm == nullptr) != (k_norm == nullptr) ||
      !aligned16(k_cache) || !aligned16(v_cache) || kc_sr % 8 != 0 ||
      vc_sr % 8 != 0 || kc_sh % 8 != 0 || vc_sh % 8 != 0 || kc_sb % 8 != 0 ||
      vc_sb % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const uint16_t*>(q),
           static_cast<const uint16_t*>(k_new),
           static_cast<const uint16_t*>(v_new),
           static_cast<uint16_t*>(k_cache),
           static_cast<uint16_t*>(v_cache),
           static_cast<const float*>(q_norm),
           static_cast<const float*>(k_norm),
           static_cast<const int32_t*>(lengths),
           static_cast<float*>(part_o),
           static_cast<float*>(part_ml),
           static_cast<uint16_t*>(out),
           q_sb, q_sh, kn_sb, kn_sh, vn_sb, vn_sh,
           kc_sb, kc_sh, kc_sr, vc_sb, vc_sh, vc_sr,
           hq, hkv, s_max, splits, scale, rope_base, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hq / hkv) {
    case 1: return launch_g<1>(b, p, s);
    case 2: return launch_g<2>(b, p, s);
    case 3: return launch_g<3>(b, p, s);
    case 4: return launch_g<4>(b, p, s);
    case 5: return launch_g<5>(b, p, s);
    case 6: return launch_g<6>(b, p, s);
    case 7: return launch_g<7>(b, p, s);
    default: return launch_g<8>(b, p, s);
  }
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
