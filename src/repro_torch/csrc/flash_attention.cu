// Blockwise online-softmax attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py, body
// `_flash_kernel`).  For q [B, Hq, Lq, Dh] against k, v [B, Hkv, Lk, Dh]
// (bf16 or f32, the same type in and out; in bf16 v and the output may
// also be 128 wide against q and k of 192, MLA's heads) it computes, row
// by row,
//
//     s = (q . k) * scale;  s = cap * tanh(s / cap)          (softcap)
//     mask = k_pos < kv_len  and (causal -> q_pos >= k_pos)
//            and (window -> q_pos - k_pos < window),   q_pos = q_offset + row
//     o = softmax(s where mask) . v,   0 for a row with no key in the mask
//
// with kv head h / (Hq / Hkv) (GQA), the running max and sum in f32, the
// masked logits set to -1e30 and p multiplied by the mask explicitly, as
// the TPU kernel does: a fully masked tile then leaves the carry as it
// was (p = 0, rescale factor exp(0) = 1), never exp(-inf - -inf) = NaN.
// Key tiles that lie wholly outside the mask (past kv_len, after the
// causal diagonal, before the window) are skipped, by the TPU kernel's
// own block-level test.  No atomics: the same inputs give the same bits.
//
// What bounds it.  At the serving shape (B = 1, Hq = 24, Hkv = 8,
// L = 512, Dh = 128, bf16, causal) the call moves 8.4 MB (2.5 us at
// 3.35 TB/s) and does 1.6 GFLOP (1.6 us at 989 TFLOP/s): it is bound by
// bytes, and in practice by latency (each CTA walks up to 8 key tiles in
// turn).  At L = 8,192 it does 412 GFLOP (0.42 ms) against 134 MB
// (0.04 ms): bound by operations, so the products go to the tensor cores.
//
// Which design serves which call is fixed by (dtype, Dh of q/k, Dh of v),
// never by a fallback at run time:
//
// bf16, Dh = 64 and 128, and q/k 192 with v 128 (`flash_fwd_wgmma<DQK,
//   DV>`; the last is MLA's heads unpadded): one warpgroup per CTA owns
//   64 query rows of one head (a 512-token prefill: 8 x 24 = 192 CTAs, at
//   two per SM all resident on the 132 SMs).  Thread 0 loads Q, K and V
//   by TMA (4-D maps over the operands' real strides, 128-byte swizzle,
//   64-column boxes; K/V rows past kv_len arrive as zeros) into two K and
//   two V slots, signalled on mbarriers, one tile ahead.  S = q.k^T is
//   `wgmma` m64n64k16 with both operands in shared memory, DQK / 16
//   k-steps across DQK / 64 boxes; O += P.V is
//   `wgmma` m64nDVk16 with P from registers (S's accumulator packed to
//   bf16 pairs is the A fragment) and V read MN-major from its [keys][Dh]
//   tile, never transposed.  S_j is issued, then P_{j-1}.V_{j-1} behind
//   it, so the tensor cores run P.V while the warpgroup does tile j's
//   softmax; O is rescaled once P.V has landed, and only in warps whose
//   row max moved.  The softmax is in base 2: scale * log2 e is folded
//   into the logit, `ex2.approx`; on tiles wholly inside the mask the
//   max is taken over the raw dots and the scale rides in one FMA per
//   exponent.  Not warp-specialised (one warpgroup issues its own TMA);
//   two CTAs per SM overlap one's softmax with the other's products.
//   At 192/128 the CTA holds Q (24 KB), two K slots (24 KB each) and two
//   V slots (16 KB each): 105 KB with the alignment slack, so two still
//   fit on an SM, where padding to 256 took the Dh 256 design's 192 KB
//   and 128-row CTAs (one an SM, 64 CTAs for a 512-token prefill: 4 x
//   16 heads) and 1.6x the products.  deepseek-v2-lite's 512-token
//   prefill (16 heads) moves 10.5 MB (3.1 us) and does 1.3 GFLOP (1.4
//   us): 128 CTAs, bound by bytes and latency; at L = 8,192, 344 GFLOP
//   (0.35 ms), bound by operations.
// bf16, Dh = 256 (`flash_fwd_ws<256, 256>`; gemma2's heads): warp-
//   specialised.  At this width O's 64 x 256 f32 carry alone is 128
//   registers a thread and one CTA of
//   Q + two K/V stages takes 192 KB of shared memory, so one CTA per SM
//   has to hide its own latency.  A producer warpgroup (`setmaxnreg`
//   down to 24 registers) issues every TMA load (the maps and boxes of
//   the Dh 64/128 design, four boxes a row); two consumer warpgroups
//   (up to 240 registers) each own 64 query rows of one head, 128 a CTA
//   (a 512-token prefill: 4 x 16 = 64 CTAs), and share each K/V tile:
//   two slots each for K and V, full and empty mbarriers per slot, so a
//   slot is refilled as soon as all eight consumer warps release it.  Q
//   stays in shared memory as wgmma's A operand.  S = q.k^T is
//   m64n64k16 over 16 k-steps; O += P.V is m64n256k16 with P from
//   registers and V MN-major.  S_j is issued, then O is rescaled by tile
//   j-1's factor while it runs and P_{j-1}.V_{j-1} is issued behind it;
//   the two warpgroups drift apart and overlap one's softmax with the
//   other's products (turns forced by named barriers, FA3's ping-pong,
//   were slower here).  The softcap's tanh is `tanh.approx.f32` (one
//   MUFU op; with tanhf the softcap was over a quarter of the kernel's
//   time at gemma2's L = 8,192; chip_smoke.py holds it to the plain
//   version on logits that reach the cap), and softcapped tiles wholly
//   inside the mask take the max of tanh and fold the cap into one FMA
//   per exponent, as the unmasked tiles do with the scale.
// bf16, Dh = 16 and 32 (`flash_fwd_bf16`): 64 query rows, 16 per
//   warp; key tiles of 64 in shared memory (rows padded by 16 bytes
//   against bank conflicts), two tiles in flight by `cp.async`;
//   S = q.k^T and O += P.V on `mma.sync.m16n8k16` with operands fetched
//   by `ldmatrix` (`.trans` for V); S stays in registers as the A
//   operand of P.V.
// f32 (`flash_fwd_f32`): 32 query rows, 4 threads per row, key tiles of
//   32, products in f32 FMAs on the CUDA cores (no TF32), P staged in
//   shared memory for P.V.
//
// Every design rounds P to bf16 for P.V in bf16 (as the JAX package's
// XLA path does, attention.py:111) and sums the row in f32 from the
// unrounded p; tiles wholly inside the mask skip the per-element test.
//
// The TPU kernel carried (m, l, acc) in VMEM across the sequential
// key-block grid axis; on Hopper CTAs run in any order, so that axis is
// the loop inside the CTA.  Query tiles are launched last-first, so the
// longest causal rows start first.
//
// Operands are read through their (batch, head, row) strides with unit
// stride inside a row (by TMA maps or pointers), so the transposed
// [B, L, H, Dh] projections need no copy; the output is contiguous
// [B, Hq, Lq, Dh].  The ragged edges (rows
// past Lq, keys past min(kv_len, Lk)) are masked here, so the wrapper pads
// nothing.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Nothing is allocated here.  Each launch is followed by
// cudaGetLastError(), whose code is returned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;
constexpr float kMaskValue = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  int hq, group, lq, lk_eff, q_offset;
  int causal, has_window, window, has_softcap;
  float scale, softcap;
  // base 2 (wgmma kernel): scale * log2 e, softcap * log2 e, scale / softcap
  float scale_log2, softcap_log2, scale_over_cap;
  // slot (1 or 2) of the row coordinate in each TMA map (wgmma kernel)
  int q_row_slot, k_row_slot, v_row_slot;
};

// The TPU kernel's block-level relevance test for key tile [k0, k0+bk)
// against query tile [q_start, q_start+bq) (absolute positions).
__device__ __forceinline__ bool tile_relevant(const Params& p, int k0, int bk,
                                              int q_start, int bq) {
  bool rel = k0 < p.lk_eff;
  if (p.causal) rel &= k0 <= q_start + bq - 1;
  if (p.has_window) rel &= (k0 + bk - 1) > (q_start - p.window);
  return rel;
}

__device__ __forceinline__ bool in_mask(const Params& p, int q_pos, int k_pos) {
  bool ok = k_pos < p.lk_eff;
  if (p.causal) ok &= q_pos >= k_pos;
  if (p.has_window) ok &= (q_pos - k_pos) < p.window;
  return ok;
}

__device__ __forceinline__ float logit(const Params& p, float dot) {
  float x = dot * p.scale;
  if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
  return x;
}

// The same logit times log2 e, for exp2f: the softmax is unchanged, as
// exp(x - m) = 2^(x log2 e - m log2 e).
__device__ __forceinline__ float logit2(const Params& p, float dot) {
  if (p.has_softcap) return p.softcap_log2 * tanhf(dot * p.scale_over_cap);
  return dot * p.scale_log2;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats as one bf16x2 word, `lo` in the low half (round to nearest).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices from shared memory: lanes 8j .. 8j+7 give the
// row addresses of matrix j, and register j receives matrix j in the mma
// fragment layout (row lane / 4, columns 2 * (lane % 4) and +1); `.trans`
// delivers each matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// Start copying rows [row0, row0 + ROWS) of a [*, D] bf16 operand (row
// stride `sl` elements) into shared memory with row pitch LD; rows >=
// nrows are zero-filled.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long sl, int row0,
                                                int nrows, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * kChunks) % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool valid = row0 + r < nrows;
    cp_async16(dst + r * LD + c * 8,
               valid ? src + (long long)(row0 + r) * sl + c * 8 : src, valid);
  }
}

template <int D, int BK>
struct Bf16Tile {
  static constexpr int kBQ = 64;     // query rows per CTA (16 per warp)
  static constexpr int kLD = D + 8;  // shared row pitch, elements
  static constexpr int kStages = 2;  // K/V tiles in flight
  static constexpr size_t kSmem =
      (size_t)(kBQ + 2 * kStages * BK) * kLD * 2;
};

template <int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  using T = Bf16Tile<D, BK>;
  constexpr int BQ = T::kBQ, LD = T::kLD;
  static_assert(D <= 32 && BK % 16 == 0, "mma.sync path: Dh = 16 or 32");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sKV = sQ + BQ * LD;  // stage s: K, then V, of BK rows each

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_start = p.q_offset + q0;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;

  // The key tiles the TPU kernel's relevance test keeps form one interval.
  const int n_tiles = (p.lk_eff + BK - 1) / BK;
  int kt_lo = n_tiles, kt_hi = 0;
  for (int kt = 0; kt < n_tiles; ++kt)
    if (tile_relevant(p, kt * BK, BK, q_start, BQ)) {
      kt_lo = min(kt_lo, kt);
      kt_hi = kt + 1;
    }

  auto load_kv = [&](int kt, int stage) {
    __nv_bfloat16* sK = sKV + stage * 2 * BK * LD;
    load_tile_async<D, LD, BK>(sK, kg, p.k_sl, kt * BK, p.lk_eff, tid);
    load_tile_async<D, LD, BK>(sK + BK * LD, vg, p.v_sl, kt * BK, p.lk_eff,
                               tid);
  };
  load_tile_async<D, LD, BQ>(sQ, qg, p.q_sl, q0, p.lq, tid);
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();

  // ldmatrix row addresses: lane l serves row l % 8 of matrix l / 8.
  const int lrow = lane & 7, lmat = lane >> 3;
  // Q (A operand): matrix m holds rows +8*(m & 1), columns +8*(m >> 1).
  const int a_off = (warp * 16 + lrow + (lmat & 1) * 8) * LD + (lmat >> 1) * 8;
  // K (B operand of S): matrices 0,1 = key rows n*8.., columns +0/+8;
  // 2,3 = the next 8 keys.
  const int k_off = (lrow + (lmat >> 1) * 8) * LD + (lmat & 1) * 8;
  // V (B operand of P.V, transposed): matrices 0,1 = key rows +0/+8 of
  // columns n*8..; 2,3 = the next 8 columns.
  const int v_off = (lrow + (lmat & 1) * 8) * LD + (lmat >> 1) * 8;

  uint32_t qf[D / 16][4];  // Q's fragments, read once
  // This thread's rows of the carry: r = 0 -> row warp*16 + g, r = 1 -> +8.
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m_run[2] = {kMaskValue, kMaskValue}, l_run[2] = {0.f, 0.f};
  const int row_base = warp * 16 + g;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) load_kv(kt + 1, stage ^ 1);  // overlaps this tile
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    if (kt == kt_lo) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], sQ + a_off + kk * 16);
    }
    const __nv_bfloat16* sK = sKV + stage * 2 * BK * LD;
    const __nv_bfloat16* sV = sK + BK * LD;
    const int k0 = kt * BK;

    // S = q . k^T for this warp's 16 rows and the tile's BK keys.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, sK + n * 8 * LD + k_off + kk * 16);
        const uint32_t b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
        mma_16816(s[n], a, b0);
        mma_16816(s[n + 1], a, b1);
      }
    }

    // Scale, softcap, mask; accumulator element (n, i) is row
    // row_base + 8*(i >> 1), key k0 + n*8 + 2t + (i & 1).  A tile wholly
    // inside the mask for every row of the CTA skips the mask test.
    const bool interior =
        k0 + BK <= p.lk_eff && (!p.causal || k0 + BK - 1 <= q_start) &&
        (!p.has_window || (q_start + BQ - 1) - k0 < p.window);
    uint64_t keep = 0;
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q_pos = q_start + row_base + 8 * (i >> 1);
        const int k_pos = k0 + n * 8 + 2 * t + (i & 1);
        const bool ok = interior || in_mask(p, q_pos, k_pos);
        const float x = ok ? logit(p, s[n][i]) : kMaskValue;
        s[n][i] = x;
        keep |= (uint64_t)ok << (n * 4 + i);
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    // a row's keys sit in the 4 lanes of one fragment group
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float m_next[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_next[r] = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_next[r]);
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float on = ((keep >> (n * 4 + i)) & 1u) ? 1.f : 0.f;
        const float pv = expf(s[n][i] - m_next[i >> 1]) * on;
        s[n][i] = pv;
        rs[i >> 1] += pv;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = alpha[r] * l_run[r] + rs[r];
      m_run[r] = m_next[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P . V: S tiles 2kk and 2kk+1 form the A fragment of keys
    // kk*16 .. kk*16+15.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, sV + kk * 16 * LD + v_off + n * 8);
        const uint32_t b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
        mma_16816(o[n], a, b0);
        mma_16816(o[n + 1], a, b1);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles ahead
  }
  cp_async_wait<0>();  // no copy outlives the CTA (none relevant: Q only)

  // o / l, 0 where no key was in the mask (l == 0, acc == 0).
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                      ((long long)b * p.hq + h) * p.lq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_base + 8 * r;
    if (row >= p.lq) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(og + (long long)row * D + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * r] / l, o[n][2 * r + 1] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16, Dh = 64 and 128, and q/k 192 with v 128: wgmma, with Q, K and V
// loaded by TMA
// ---------------------------------------------------------------------------

template <int DQK, int DV>
struct WgTile {
  static constexpr int kBQ = 64, kBK = 64;  // query rows, keys per tile
  static constexpr int kBoxBytes = 64 * 128;  // one [64 rows][64 cols] box
  // 64-column TMA boxes per row of Q or K, and of V
  static constexpr int kQKBoxes = DQK / 64, kVBoxes = DV / 64;
  static constexpr int kQKBytes = kQKBoxes * kBoxBytes;  // Q, or K of a tile
  static constexpr int kVBytes = kVBoxes * kBoxBytes;    // V of a tile
  // 1 KB of slack to align the tiles to 1024 bytes (the swizzle atom);
  // Q, two K slots, two V slots; barriers [0] Q, [1 + s] K slot s,
  // [3 + s] V slot s
  static constexpr size_t kSmem =
      1024 + 3 * (size_t)kQKBytes + 2 * (size_t)kVBytes + 8 * 5;
};

// A box of `map` whose rows sit at coordinate slot `row_slot` (1 or 2)
// and heads at the other (see make_map).
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int col, int row,
                                        int head, int b, int row_slot) {
  if (row_slot == 1)
    tma_load_4d(dst, map, bar, col, row, head, b);
  else
    tma_load_4d(dst, map, bar, col, head, row, b);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The Dh = 256 design's softcap tanh: `tanh.approx.f32`, one MUFU
// instruction (max relative error 2^-10.99), and its logit2.
__device__ __forceinline__ float tanh_cap(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float logit2_cap(const Params& p, float dot) {
  if (p.has_softcap) return p.softcap_log2 * tanh_cap(dot * p.scale_over_cap);
  return dot * p.scale_log2;
}

// The online softmax of one 64 x 64 tile in base 2, for the warpgroup
// whose 64 query rows start at absolute position q_start: s (the f32
// accumulator of q . k^T,
// s[4i + e] = row row_base + 8*(e >> 1), key k0 + 8i + 2t + (e & 1))
// becomes p, (m_run, l_run) advance and alpha is each row's rescale
// factor.  The Dh = 256 design's; the Dh = 64/128 design keeps the same
// steps inline, without the softcapped interior path.
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[32],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2], int q_start,
                                             int row_base, int t, int k0) {
  constexpr int BQ = 64, BK = 64;
  // Online softmax in base 2.  s[4i + e] is row row_base + 8*(e >> 1),
  // key k0 + 8i + 2t + (e & 1).
  const bool interior =
      k0 + BK <= p.lk_eff && (!p.causal || k0 + BK - 1 <= q_start) &&
      (!p.has_window || (q_start + BQ - 1) - k0 < p.window);
  float mx[2] = {kMaskValue, kMaskValue}, m_next[2];
  float rs[2] = {0.f, 0.f};
  if (interior && p.has_softcap && p.softcap_log2 > 0.f) {
    // Every key counts and the logit is softcap log2 e * t, t = tanh(dot
    // * scale / softcap): take the max of t (the factor is positive),
    // then fold the factor into one FMA per exponent.
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      s[e] = tanh_cap(s[e] * p.scale_over_cap);
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_next[r] = fmaxf(m_run[r], mx[r] * p.softcap_log2);
      alpha[r] = ex2(m_run[r] - m_next[r]);
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = ex2(fmaf(s[e], p.softcap_log2, -m_next[r]));
      rs[r] += s[e];
    }
  } else if (interior && !p.has_softcap) {
    // Every key counts and the logit is dot * scale * log2 e: take the
    // max of the raw dots (the scale is positive and rounding is
    // monotonic), then fold the scale into one FMA per exponent.
#pragma unroll
    for (int e = 0; e < BK / 2; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_next[r] = fmaxf(m_run[r], mx[r] * p.scale_log2);
      alpha[r] = ex2(m_run[r] - m_next[r]);
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = ex2(fmaf(s[e], p.scale_log2, -m_next[r]));
      rs[r] += s[e];
    }
  } else {
    // Masked logits are -1e30 and p is multiplied by the mask, as the
    // TPU kernel does: a row with no key yet keeps p = 0, never NaN.
    uint32_t keep = 0;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q_pos = q_start + row_base + 8 * (e >> 1);
        const int k_pos = k0 + i * 8 + 2 * t + (e & 1);
        const bool ok = interior || in_mask(p, q_pos, k_pos);
        const float x = ok ? logit2_cap(p, s[4 * i + e]) : kMaskValue;
        s[4 * i + e] = x;
        keep |= (uint32_t)ok << (4 * i + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_next[r] = fmaxf(m_run[r], mx[r]);
      alpha[r] = ex2(m_run[r] - m_next[r]);
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = ex2(s[e] - m_next[r]) * (((keep >> e) & 1u) ? 1.f : 0.f);
      rs[r] += s[e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l_run[r] = alpha[r] * l_run[r] + rs[r];
    m_run[r] = m_next[r];
  }
}

// Issues O += P . V for one tile (and commits it): P from registers, V
// read MN-major from its [keys][Dh] tile at shared address `v_addr`.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&pa)[4][4],
                                           uint32_t v_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = desc_sw128(v_addr + kk * 16 * 128, 64 * 128, 1024);
    if constexpr (D == 256)
      wgmma_rs_bf16_n256_tb(o, pa[kk], dv);
    else if constexpr (D == 128)
      wgmma_rs_bf16_n128_tb(o, pa[kk], dv);
    else
      wgmma_rs_bf16_n64_tb(o, pa[kk], dv);
  }
  wgmma_commit();
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, Params p) {
  using T = WgTile<DQK, DV>;
  constexpr int BQ = T::kBQ, BK = T::kBK;
  static_assert((DQK == DV && (DQK == 64 || DQK == 128)) ||
                    (DQK == 192 && DV == 128),
                "wgmma path: Dh = 64 or 128, or q/k 192 with v 128");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + T::kQKBytes;      // slot s at s * kQKBytes
  unsigned char* sV = sK + 2 * T::kQKBytes;  // slot s at s * kVBytes
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + 2 * T::kVBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // accumulator coordinates
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const int q_start = p.q_offset + q0;

  // The key tiles the TPU kernel's relevance test keeps form one interval.
  const int n_tiles = (p.lk_eff + BK - 1) / BK;
  int kt_lo = n_tiles, kt_hi = 0;
  for (int kt = 0; kt < n_tiles; ++kt)
    if (tile_relevant(p, kt * BK, BK, q_start, BQ)) {
      kt_lo = min(kt_lo, kt);
      kt_hi = kt + 1;
    }
  const int n = max(kt_hi - kt_lo, 0);

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 issues every copy: K or V of the j-th relevant tile into
  // slot j % 2.
  auto load = [&](bool is_v, int j) {
    const int slot = j & 1;
    const int bytes = is_v ? T::kVBytes : T::kQKBytes;
    unsigned char* dst = (is_v ? sV : sK) + slot * bytes;
    uint64_t* bj = &bar[(is_v ? 3 : 1) + slot];
    mbar_arrive_expect_tx(bj, bytes);
#pragma unroll
    for (int x = 0; x < (is_v ? T::kVBoxes : T::kQKBoxes); ++x)
      tma_box(dst + x * T::kBoxBytes, is_v ? &tm_v : &tm_k, bj, x * 64,
              (kt_lo + j) * BK, kvh, b, is_v ? p.v_row_slot : p.k_row_slot);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar[0], T::kQKBytes);
#pragma unroll
    for (int x = 0; x < T::kQKBoxes; ++x)
      tma_box(sQ + x * T::kBoxBytes, &tm_q, &bar[0], x * 64, q0, h, b,
              p.q_row_slot);
    if (n > 0) {
      load(false, 0);
      load(true, 0);
    }
    if (n > 1) load(false, 1);
  }

  // This thread's rows of the carry: r = 0 -> row warp*16 + g, r = 1 -> +8.
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kMaskValue, kMaskValue}, l_run[2] = {0.f, 0.f};
  uint32_t pa[BK / 16][4];  // P of the previous tile, the A operand of P.V
  const int row_base = warp * 16 + g;
  const uint32_t q_addr = smem_u32(sQ);
  mbar_wait(&bar[0], 0);  // always: no copy may outlive the CTA

  // Tile j: S_j = q . k_j^T is issued, then O += P_{j-1} . V_{j-1} behind
  // it, so the tensor cores run P.V while this warpgroup does tile j's
  // softmax; O is rescaled once P.V has landed.
  for (int j = 0; j < n; ++j) {
    if (tid == 0 && j > 0) {
      // slots released by the barrier that ended tile j - 1
      if (j + 1 < n) load(false, j + 1);
      load(true, j);
    }
    mbar_wait(&bar[1 + (j & 1)], (j >> 1) & 1);
    const uint32_t k_addr = smem_u32(sK + (j & 1) * T::kQKBytes);
    float s[BK / 2];
    wgmma_fence();
    // k-step kk reads 16 columns of box kk / 4 (32 bytes at kk % 4)
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const uint32_t off = (kk >> 2) * T::kBoxBytes + (kk & 3) * 32;
      wgmma_ss_bf16_n64(s, desc_sw128(q_addr + off, 16, 1024),
                        desc_sw128(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    if (j > 0) {
      const int jv = j - 1;
      mbar_wait(&bar[3 + (jv & 1)], (jv >> 1) & 1);
      pv_product<DV>(o, pa, smem_u32(sV + (jv & 1) * T::kVBytes));
      wgmma_wait<1>();  // S_j has landed; P.V may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);

    // Online softmax in base 2.  s[4i + e] is row row_base + 8*(e >> 1),
    // key k0 + 8i + 2t + (e & 1).
    const int k0 = (kt_lo + j) * BK;
    const bool interior =
        k0 + BK <= p.lk_eff && (!p.causal || k0 + BK - 1 <= q_start) &&
        (!p.has_window || (q_start + BQ - 1) - k0 < p.window);
    float mx[2] = {kMaskValue, kMaskValue}, m_next[2], alpha[2];
    float rs[2] = {0.f, 0.f};
    if (interior && !p.has_softcap) {
      // Every key counts and the logit is dot * scale * log2 e: take the
      // max of the raw dots (the scale is positive and rounding is
      // monotonic), then fold the scale into one FMA per exponent.
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_next[r] = fmaxf(m_run[r], mx[r] * p.scale_log2);
        alpha[r] = ex2(m_run[r] - m_next[r]);
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int r = (e >> 1) & 1;
        s[e] = ex2(fmaf(s[e], p.scale_log2, -m_next[r]));
        rs[r] += s[e];
      }
    } else {
      // Masked logits are -1e30 and p is multiplied by the mask, as the
      // TPU kernel does: a row with no key yet keeps p = 0, never NaN.
      uint32_t keep = 0;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q_pos = q_start + row_base + 8 * (e >> 1);
          const int k_pos = k0 + i * 8 + 2 * t + (e & 1);
          const bool ok = interior || in_mask(p, q_pos, k_pos);
          const float x = ok ? logit2(p, s[4 * i + e]) : kMaskValue;
          s[4 * i + e] = x;
          keep |= (uint32_t)ok << (4 * i + e);
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_next[r] = fmaxf(m_run[r], mx[r]);
        alpha[r] = ex2(m_run[r] - m_next[r]);
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int r = (e >> 1) & 1;
        s[e] = ex2(s[e] - m_next[r]) * (((keep >> e) & 1u) ? 1.f : 0.f);
        rs[r] += s[e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = alpha[r] * l_run[r] + rs[r];
      m_run[r] = m_next[r];
    }
    // P_{j-1} . V_{j-1} has landed (unconditional, so the compiler sees
    // a wait on every path from the product to the rescale)
    wgmma_wait<0>();
    fence_regs(o);
    // rescale only where a row's max moved (most tiles leave it)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int e = 0; e < DV / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
    }
    // S's accumulator is the A fragment of P.V: keys 16kk .. 16kk + 15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    __syncthreads();  // every warp is done with K_j and V_{j-1}
  }
  if (n > 0) {
    const int jv = n - 1;
    mbar_wait(&bar[3 + (jv & 1)], (jv >> 1) & 1);
    pv_product<DV>(o, pa, smem_u32(sV + (jv & 1) * T::kVBytes));
    wgmma_wait<0>();
    fence_regs(o);
  }

  // o / l, 0 where no key was in the mask (l == 0, acc == 0).
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                      ((long long)b * p.hq + h) * p.lq * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_base + 8 * r;
    if (row >= p.lq) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<uint32_t*>(og + (long long)row * DV + i * 8 + 2 * t) =
          pack_bf16(o[4 * i + 2 * r] / l, o[4 * i + 2 * r + 1] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16, Dh = 256: warp-specialised wgmma, Q, K and V loaded by TMA
// ---------------------------------------------------------------------------

// Shipped at 256/256 only; tools/flash256_variants.py also builds it at
// q/k 192, v 128 against the one-warpgroup design MLA's heads take.
template <int DQK, int DV>
struct WsTile {
  static constexpr int kConsumers = 2;  // warpgroups of 64 query rows
  static constexpr int kThreads = (kConsumers + 1) * 128;  // + a producer
  static constexpr int kBQ = 64 * kConsumers, kBK = 64;  // rows, keys a tile
  static constexpr int kBoxBytes = 64 * 128;  // one [64 rows][64 cols] box
  // 64-column TMA boxes per row of Q or K, and of V
  static constexpr int kQKBoxes = DQK / 64, kVBoxes = DV / 64;
  // 64 rows of Q or K (32 KB at 256), and of V
  static constexpr int kQKBytes = kQKBoxes * kBoxBytes;
  static constexpr int kVBytes = kVBoxes * kBoxBytes;
  // barriers: [0] Q; [1 + s] K slot s full, [3 + s] V full, [5 + s] K
  // empty, [7 + s] V empty
  static constexpr int kBars = 9;
  // 1 KB of slack to align the tiles to 1024 bytes (the swizzle atom);
  // Q of every consumer, two K slots, two V slots
  static constexpr size_t kSmem = 1024 + (size_t)(kConsumers + 2) * kQKBytes +
                                  2 * (size_t)kVBytes + 8 * kBars;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(WsTile<DQK, DV>::kThreads, 1)
    flash_fwd_ws(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, Params p) {
  using T = WsTile<DQK, DV>;
  constexpr int NC = T::kConsumers, BQ = T::kBQ, BK = T::kBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + NC * T::kQKBytes;  // slot s at s * kQKBytes
  unsigned char* sV = sK + 2 * T::kQKBytes;   // slot s at s * kVBytes
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + 2 * T::kVBytes);
  uint64_t* const q_full = bar;
  uint64_t* const k_full = bar + 1;
  uint64_t* const v_full = bar + 3;
  uint64_t* const k_empty = bar + 5;
  uint64_t* const v_empty = bar + 7;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;

  // The key tiles the TPU kernel's relevance test keeps (for the CTA's
  // BQ rows) form one interval; both consumers walk all of it.
  const int n_tiles = (p.lk_eff + BK - 1) / BK;
  int kt_lo = n_tiles, kt_hi = 0;
  for (int kt = 0; kt < n_tiles; ++kt)
    if (tile_relevant(p, kt * BK, BK, p.q_offset + q0, BQ)) {
      kt_lo = min(kt_lo, kt);
      kt_hi = kt + 1;
    }
  const int n = max(kt_hi - kt_lo, 0);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(&k_full[slot], 1);
      mbar_init(&v_full[slot], 1);
      mbar_init(&k_empty[slot], 4 * NC);  // one arrival per consumer warp
      mbar_init(&v_empty[slot], 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {
    // The producer warpgroup: one thread issues every copy, K_j and V_j
    // into slot j % 2 once the consumers have released tile j - 2 there.
    setmaxnreg_dec<24>();
    if (tid == NC * 128) {
      mbar_arrive_expect_tx(q_full, NC * T::kQKBytes);
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int x = 0; x < T::kQKBoxes; ++x)
          tma_box(sQ + c * T::kQKBytes + x * T::kBoxBytes, &tm_q, q_full,
                  x * 64, q0 + 64 * c, h, b, p.q_row_slot);
      for (int j = 0; j < n; ++j) {
        const int slot = j & 1, row = (kt_lo + j) * BK;
        const uint32_t parity = ((j >> 1) + 1) & 1;  // release of j - 2
        if (j >= 2) mbar_wait(&k_empty[slot], parity);
        mbar_arrive_expect_tx(&k_full[slot], T::kQKBytes);
#pragma unroll
        for (int x = 0; x < T::kQKBoxes; ++x)
          tma_box(sK + slot * T::kQKBytes + x * T::kBoxBytes, &tm_k,
                  &k_full[slot], x * 64, row, kvh, b, p.k_row_slot);
        if (j >= 2) mbar_wait(&v_empty[slot], parity);
        mbar_arrive_expect_tx(&v_full[slot], T::kVBytes);
#pragma unroll
        for (int x = 0; x < T::kVBoxes; ++x)
          tma_box(sV + slot * T::kVBytes + x * T::kBoxBytes, &tm_v,
                  &v_full[slot], x * 64, row, kvh, b, p.v_row_slot);
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg .. + 63.
    setmaxnreg_inc<240>();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;  // accumulator coordinates
    const int wq0 = q0 + 64 * wg;
    const int q_start = p.q_offset + wq0;
    // This thread's rows of the carry: r = 0 -> row warp*16 + g, r = 1 -> +8.
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kMaskValue, kMaskValue}, l_run[2] = {0.f, 0.f};
    uint32_t pa[BK / 16][4];  // P of the previous tile, the A operand of P.V
    const int row_base = warp * 16 + g;
    const uint32_t q_addr = smem_u32(sQ + wg * T::kQKBytes);
    mbar_wait(q_full, 0);  // always: no copy may outlive the CTA

    // Tile j: S_j = q . k_j^T is issued, O is rescaled by tile j - 1's
    // factor while S_j runs, and O += P_{j-1} . V_{j-1} is issued behind
    // it, so the tensor cores run both while this warpgroup does tile
    // j's softmax.  Each warp releases K_j once S_j has landed and
    // V_{j-1} once P.V has.
    float alpha[2] = {1.f, 1.f};
    auto rescale = [&]() {  // only where a row's max moved (most tiles)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int e = 0; e < DV / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      }
    };
    for (int j = 0; j < n; ++j) {
      mbar_wait(&k_full[j & 1], (j >> 1) & 1);
      const uint32_t k_addr = smem_u32(sK + (j & 1) * T::kQKBytes);
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t off = (kk >> 2) * T::kBoxBytes + (kk & 3) * 32;
        wgmma_ss_bf16_n64(s, desc_sw128(q_addr + off, 16, 1024),
                          desc_sw128(k_addr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if (j > 0) {
        const int jv = j - 1;
        rescale();
        mbar_wait(&v_full[jv & 1], (jv >> 1) & 1);
        pv_product<DV>(o, pa, smem_u32(sV + (jv & 1) * T::kVBytes));
        wgmma_wait<1>();  // S_j has landed; P.V may still run
      } else {
        wgmma_wait<0>();
      }
      fence_regs(s);
      if (lane == 0) mbar_arrive(&k_empty[j & 1]);

      softmax_tile(p, s, m_run, l_run, alpha, q_start, row_base, t,
                   (kt_lo + j) * BK);
      // P_{j-1} . V_{j-1} has landed (unconditional, so the compiler sees
      // a wait on every path from the product to the next rescale)
      wgmma_wait<0>();
      fence_regs(o);
      if (j > 0 && lane == 0) mbar_arrive(&v_empty[(j - 1) & 1]);
      // S's accumulator is the A fragment of P.V: keys 16kk .. 16kk + 15
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
    if (n > 0) {
      const int jv = n - 1;
      rescale();
      mbar_wait(&v_full[jv & 1], (jv >> 1) & 1);
      pv_product<DV>(o, pa, smem_u32(sV + (jv & 1) * T::kVBytes));
      wgmma_wait<0>();
      fence_regs(o);
    }

    // o / l, 0 where no key was in the mask (l == 0, acc == 0).
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                        ((long long)b * p.hq + h) * p.lq * DV;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq0 + row_base + 8 * r;
      if (row >= p.lq) continue;
      const float l = l_run[r] == 0.f ? 1.f : l_run[r];
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
        *reinterpret_cast<uint32_t*>(og + (long long)row * DV + i * 8 +
                                     2 * t) =
            pack_bf16(o[4 * i + 2 * r] / l, o[4 * i + 2 * r + 1] / l);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

template <int D>
struct F32Tile {
  static constexpr int kBQ = 32, kBK = 32;
  static constexpr int kLD = D + 1;     // q, k pitch (odd: no bank conflicts)
  static constexpr int kLDP = kBK + 1;  // p pitch
  static constexpr size_t kSmem =
      (size_t)((kBQ + kBK) * kLD + kBK * D + kBQ * kLDP) * 4;
};

template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long sl, int row0,
                                              int nrows, int tid) {
  for (int idx = tid; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * LD + c] =
        row0 + r < nrows ? src[(long long)(row0 + r) * sl + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Params p) {
  using T = F32Tile<D>;
  constexpr int BQ = T::kBQ, BK = T::kBK, LD = T::kLD, LDP = T::kLDP;
  constexpr int kCols = D / 4;  // output columns per thread
  extern __shared__ __align__(16) float smem_f[];
  float* sQ = smem_f;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;  // pitch D
  float* sP = sV + BK * D;

  const int tid = threadIdx.x;
  const int r = tid >> 2;  // this thread's query row in the tile
  const int c4 = tid & 3;  // keys c4 + 4j, output columns c4 + 4j
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_start = p.q_offset + q0;
  const int q_pos = q_start + r;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;

  load_tile_f32<D, LD, BQ>(sQ, qg, p.q_sl, q0, p.lq, tid);

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  float m_run = kMaskValue, l_run = 0.f;

  const int n_tiles = (p.lk_eff + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    if (!tile_relevant(p, k0, BK, q_start, BQ)) continue;  // CTA-uniform
    __syncthreads();
    load_tile_f32<D, LD, BK>(sK, kg, p.k_sl, k0, p.lk_eff, tid);
    load_tile_f32<D, D, BK>(sV, vg, p.v_sl, k0, p.lk_eff, tid);
    __syncthreads();

    float s[BK / 4];
    uint32_t keep = 0;
    float mx = kMaskValue;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int kk = c4 + 4 * j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(sQ[r * LD + d], sK[kk * LD + d], dot);
      const bool ok = in_mask(p, q_pos, k0 + kk);
      s[j] = ok ? logit(p, dot) : kMaskValue;
      keep |= (uint32_t)ok << j;
      mx = fmaxf(mx, s[j]);
    }
    // a row's 4 threads are adjacent lanes
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_next);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float pv = expf(s[j] - m_next) * (((keep >> j) & 1u) ? 1.f : 0.f);
      sP[r * LDP + c4 + 4 * j] = pv;
      rs += pv;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run = alpha * l_run + rs;
    m_run = m_next;
    __syncthreads();  // the row's p is complete in shared memory

#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float pv = sP[r * LDP + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] = fmaf(pv, sV[kk * D + c4 + 4 * j], acc[j]);
    }
  }

  const int row = q0 + r;
  if (row < p.lq) {
    float* og = static_cast<float*>(p.o) +
                (((long long)b * p.hq + h) * p.lq + row) * D;
    const float l = l_run == 0.f ? 1.f : l_run;
#pragma unroll
    for (int j = 0; j < kCols; ++j) og[c4 + 4 * j] = acc[j] / l;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int q_tile, size_t smem, int b, const Params& p,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((p.lq + q_tile - 1) / q_tile, p.hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, int BK>
int launch_bf16(int b, int, const Params& p, cudaStream_t s) {
  using T = Bf16Tile<D, BK>;
  return launch(flash_fwd_bf16<D, BK>, T::kBQ, T::kSmem, b, p, s);
}

template <int D>
int launch_f32(int b, int, const Params& p, cudaStream_t s) {
  using T = F32Tile<D>;
  return launch(flash_fwd_f32<D>, T::kBQ, T::kSmem, b, p, s);
}

// TMA map of a bf16 operand [batch, heads, rows, d] read through its
// (batch, head, row) strides in elements (0 for a dimension of size 1,
// which is never stepped): boxes of [64 rows][64 columns] with the
// 128-byte swizzle, rows >= `rows` arriving as zeros.  The map's
// dimensions run in order of stride, so the row coordinate sits at slot
// 1 (rows before heads) or 2 (heads before rows: the transposed
// [B, L, H, Dh] projections), returned in `row_slot`.
int make_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
             int batch, long long sl, long long sh, long long sb,
             int* row_slot) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t row_b = sl > 0 ? (cuuint64_t)sl * 2 : (cuuint64_t)d * 2;
  const cuuint64_t head_b = sh > 0 ? (cuuint64_t)sh * 2 : row_b * rows;
  const bool heads_first = head_b < row_b;
  const cuuint64_t batch_b =
      sb > 0 ? (cuuint64_t)sb * 2
             : (heads_first ? row_b * rows : head_b * heads);
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {row_b, head_b, batch_b};
  cuuint32_t box[4] = {64, 64, 1, 1};
  if (heads_first) {
    dims[1] = heads;
    dims[2] = rows;
    strides[0] = head_b;
    strides[1] = row_b;
    box[1] = 1;
    box[2] = 64;
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  *row_slot = heads_first ? 2 : 1;
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The three maps of a wgmma design (Q and K DQK wide, V DV wide), row
// slots set in p.
template <int DQK, int DV>
int make_maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv, int b,
              int hkv, Params* p) {
  const int kv_rows = p->lk_eff > 0 ? p->lk_eff : 1;  // no tile is read at 0
  int err = make_map(mq, p->q, DQK, p->lq, p->hq, b, p->q_sl, p->q_sh,
                     p->q_sb, &p->q_row_slot);
  if (!err)
    err = make_map(mk, p->k, DQK, kv_rows, hkv, b, p->k_sl, p->k_sh, p->k_sb,
                   &p->k_row_slot);
  if (!err)
    err = make_map(mv, p->v, DV, kv_rows, hkv, b, p->v_sl, p->v_sh, p->v_sb,
                   &p->v_row_slot);
  return err;
}

template <int DQK, int DV>
int launch_wgmma(int b, int hkv, const Params& p0, cudaStream_t s) {
  using T = WgTile<DQK, DV>;
  Params p = p0;
  CUtensorMap mq, mk, mv;
  const int err = make_maps<DQK, DV>(&mq, &mk, &mv, b, hkv, &p);
  if (err) return err;
  auto kernel = flash_fwd_wgmma<DQK, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.lq + T::kBQ - 1) / T::kBQ, p.hq, b);
  kernel<<<grid, kThreads, T::kSmem, s>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_ws(int b, int hkv, const Params& p0, cudaStream_t s) {
  using T = WsTile<DQK, DV>;
  Params p = p0;
  CUtensorMap mq, mk, mv;
  const int err = make_maps<DQK, DV>(&mq, &mk, &mv, b, hkv, &p);
  if (err) return err;
  auto kernel = flash_fwd_ws<DQK, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.lq + T::kBQ - 1) / T::kBQ, p.hq, b);
  kernel<<<grid, T::kThreads, T::kSmem, s>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

// The design that serves a (dtype, d, dv): its launcher, its kernel, and
// its dynamic shared memory and threads per CTA; `launch` is null where
// there is none.  The one table both entry points below read.
struct Design {
  int (*launch)(int b, int hkv, const Params& p, cudaStream_t s);
  const void* kernel;
  size_t smem;
  int threads;
};

template <int D, int BK>
Design bf16_design() {
  return {launch_bf16<D, BK>, (const void*)flash_fwd_bf16<D, BK>,
          Bf16Tile<D, BK>::kSmem, kThreads};
}

template <int D>
Design f32_design() {
  return {launch_f32<D>, (const void*)flash_fwd_f32<D>, F32Tile<D>::kSmem,
          kThreads};
}

template <int DQK, int DV>
Design wgmma_design() {
  return {launch_wgmma<DQK, DV>, (const void*)flash_fwd_wgmma<DQK, DV>,
          WgTile<DQK, DV>::kSmem, kThreads};
}

template <int DQK, int DV>
Design ws_design() {
  using T = WsTile<DQK, DV>;
  return {launch_ws<DQK, DV>, (const void*)flash_fwd_ws<DQK, DV>, T::kSmem,
          T::kThreads};
}

Design design_for(int dtype, int d, int dv) {
  if (d != dv) {  // the pairs of unequal widths that have a design
    if (dtype == 1 && d == 192 && dv == 128) return wgmma_design<192, 128>();
    return {};
  }
  if (dtype == 1) {
    switch (d) {
      case 16: return bf16_design<16, 64>();
      case 32: return bf16_design<32, 64>();
      case 64: return wgmma_design<64, 64>();
      case 128: return wgmma_design<128, 128>();
      case 256: return ws_design<256, 256>();
    }
  } else if (dtype == 0) {
    switch (d) {
      case 16: return f32_design<16>();
      case 32: return f32_design<32>();
      case 64: return f32_design<64>();
      case 128: return f32_design<128>();
      case 256: return f32_design<256>();
    }
  }
  return {};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  d is q's and k's head size, dv v's
// (and the output's); the design is chosen by (dtype, d, dv) alone.
// Strides are in elements; the output is contiguous.  has_window /
// has_softcap select the optional masks.  Returns a cudaError_t code
// (0 = ok; cudaErrorInvalidValue for a (dtype, d, dv) without a design).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int b, int hq, int hkv, int lq,
                           int lk, int d, int dv, long long q_sb,
                           long long q_sh,
                           long long q_sl, long long k_sb, long long k_sh,
                           long long k_sl, long long v_sb, long long v_sh,
                           long long v_sl, float scale, int causal,
                           int has_window, int window, int has_softcap,
                           float softcap, int q_offset, int kv_len,
                           void* stream) {
  if (b < 1 || b > 65535 || hq < 1 || hq > 65535 || hkv < 1 || hq % hkv != 0 ||
      lq < 1 || lk < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_sl = q_sl;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_sl = k_sl;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_sl = v_sl;
  p.hq = hq;
  p.group = hq / hkv;
  p.lq = lq;
  p.lk_eff = kv_len < 0 ? 0 : (kv_len < lk ? kv_len : lk);
  p.q_offset = q_offset;
  p.causal = causal != 0;
  p.has_window = has_window != 0;
  p.window = window;
  p.has_softcap = has_softcap != 0;
  p.scale = scale;
  p.softcap = softcap;
  const float log2e = 1.4426950408889634f;
  p.scale_log2 = scale * log2e;
  p.softcap_log2 = softcap * log2e;
  p.scale_over_cap = has_softcap ? scale / softcap : 0.f;
  p.q_row_slot = p.k_row_slot = p.v_row_slot = 1;
  const Design ds = design_for(dtype, d, dv);
  if (ds.launch == nullptr) return (int)cudaErrorInvalidValue;
  return ds.launch(b, hkv, p, static_cast<cudaStream_t>(stream));
}

// The design that serves (dtype, d, dv), as flash_attention_launch
// chooses it: out[0] its dynamic shared memory per CTA in bytes, out[1]
// its threads per CTA, out[2] the CTAs that fit on one SM of this
// device.  Returns a cudaError_t code.
int flash_attention_design(int dtype, int d, int dv, int* out) {
  const Design ds = design_for(dtype, d, dv);
  if (ds.launch == nullptr) return (int)cudaErrorInvalidValue;
  out[0] = (int)ds.smem;
  out[1] = ds.threads;
  if (ds.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ds.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ds.smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], ds.kernel, ds.threads, ds.smem);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
