// Blockwise online-softmax attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py, body
// `_flash_kernel`).  For q [B, Hq, Lq, Dh] against k, v [B, Hkv, Lk, Dh]
// (bf16 or f32, the same type in and out) it computes, row by row,
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
// bytes, and in practice by launch latency.  At L = 8,192 it does
// 412 GFLOP (0.42 ms) against 134 MB (0.04 ms): bound by operations, so
// the products go to the tensor cores.
//
// Design (simple first; wgmma, TMA and warp specialisation come later).
// One CTA of 4 warps owns (b, h, a tile of query rows) and walks the key
// tiles of its kv head in order, keeping the carry in registers:
//
// bf16 (`flash_fwd_bf16`): 64 query rows, 16 per warp; key tiles of 64
//   (32 at Dh = 256) in shared memory (rows padded by 16 bytes against
//   bank conflicts), two tiles in flight: `cp.async` fetches the next
//   K/V tile while the tensor cores work on this one.  S = q.k^T and
//   O += P.V run on `mma.sync.m16n8k16` (bf16 in, f32 accumulate) with
//   operands fetched by `ldmatrix` (`.trans` for V); Q's fragments stay
//   in registers (up to Dh = 128).  S stays in registers, and its
//   accumulator layout is the A-operand layout of the P.V product, so P
//   never touches shared memory.  P is rounded to bf16 for P.V (as the
//   JAX package's XLA path does, attention.py:111); the row sum uses the
//   unrounded f32 p.  Tiles wholly inside the mask skip the per-element
//   test.  The tiles need more than the default 48 KB of shared memory
//   from Dh = 128 on, granted per launch.
// f32 (`flash_fwd_f32`): 32 query rows, 4 threads per row, key tiles of
//   32, products in f32 FMAs on the CUDA cores (no TF32), P staged in
//   shared memory for P.V.
//
// The TPU kernel carried (m, l, acc) in VMEM across the sequential
// key-block grid axis; on Hopper CTAs run in any order, so that axis is
// the loop inside the CTA.  Query tiles are launched last-first, so the
// longest causal rows start first.
//
// Operands are read through their (batch, head, row) strides with unit
// stride inside a row, so the transposed [B, L, H, Dh] projections need no
// copy; the output is contiguous [B, Hq, Lq, Dh].  The ragged edges (rows
// past Lq, keys past min(kv_len, Lk)) are masked here, so the wrapper pads
// nothing.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Nothing is allocated here.  Each launch is followed by
// cudaGetLastError(), whose code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 b16 matrices from shared memory: lanes 8j .. 8j+7 give the
// row addresses of matrix j, and register j receives matrix j in the mma
// fragment layout (row lane / 4, columns 2 * (lane % 4) and +1); `.trans`
// delivers each matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// 16 bytes from device to shared memory without a register round trip;
// the destination is zero-filled when !valid (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
  // Q's fragments stay in registers up to Dh = 128; at 256 the output
  // carry alone takes 128 registers, so Q is re-read from shared memory.
  constexpr bool kQInRegs = D <= 128;
  static_assert(D % 16 == 0 && BK % 16 == 0, "mma tiles are 16 deep");
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

  uint32_t qf[kQInRegs ? D / 16 : 1][4];
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
    if constexpr (kQInRegs) {
      if (kt == kt_lo) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[kk], sQ + a_off + kk * 16);
      }
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
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, sQ + a_off + kk * 16);
      }
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
int launch_bf16(int b, const Params& p, cudaStream_t s) {
  using T = Bf16Tile<D, BK>;
  return launch(flash_fwd_bf16<D, BK>, T::kBQ, T::kSmem, b, p, s);
}

template <int D>
int launch_f32(int b, const Params& p, cudaStream_t s) {
  using T = F32Tile<D>;
  return launch(flash_fwd_f32<D>, T::kBQ, T::kSmem, b, p, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the output
// is contiguous.  has_window / has_softcap select the optional masks.
// Returns a cudaError_t code (0 = ok).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int b, int hq, int hkv, int lq,
                           int lk, int d, long long q_sb, long long q_sh,
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (d) {
      case 16: return launch_bf16<16, 64>(b, p, s);
      case 32: return launch_bf16<32, 64>(b, p, s);
      case 64: return launch_bf16<64, 64>(b, p, s);
      case 128: return launch_bf16<128, 64>(b, p, s);
      case 256: return launch_bf16<256, 32>(b, p, s);
    }
  } else {
    switch (d) {
      case 16: return launch_f32<16>(b, p, s);
      case 32: return launch_f32<32>(b, p, s);
      case 64: return launch_f32<64>(b, p, s);
      case 128: return launch_f32<128>(b, p, s);
      case 256: return launch_f32<256>(b, p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
