// The MoE layer of a decode step for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's MoE layer is plain jnp
// (`src/repro/models/moe.py`: a softmax router, `jax.lax.top_k`, a sort
// and `jax.lax.ragged_dot`), and the port computed the same in plain
// PyTorch (`models/moe.py::route` and `dispatch`: two sorts, gathers, three
// `torch._grouped_mm` over E groups, an inverse scatter and a combine).
// It was added because at decode sizes that chain is about 32 launches a
// layer, most of a decode step, while the work is a handful of matrix-vector
// products.  For T tokens (a few) of width D, E experts of width F, top K:
//
//   logits <- x · router                 (f32: x widened, the router f32)
//   p      <- softmax(logits)            (f32)
//   ids    <- the K largest p, ties to the lower expert id (a stable
//             descending sort's order, and jax.lax.top_k's)
//   gates  <- those p, divided by their sum where the config asks
//   h[t,j] <- bf16(bf16(silu(bf16(x·Wg[e]))) · bf16(x·Wu[e])),  e = ids[t,j]
//   out[t] <- bf16(sum over j of bf16(bf16(h[t,j]·Wd[e]) · bf16(gate[t,j])))
//
// rounded where the grouped path rounds: each product's sum is f32 and
// rounds to bf16 as `_grouped_mm`'s output does, SiLU and the products
// round to bf16 as the bf16 tensor ops do, and the gated rows are summed
// in f32 and rounded once, as a bf16 `sum` does.
//
// What bounds it.  At T = 1 the layer reads the K selected experts' three
// bf16 matrices once: K · 3 · D · F · 2 bytes (qwen3-moe 75.5 MB, 22.5 us at
// 3.35 TB/s; deepseek-v2-lite 103.8 MB, 31.0 us), and the f32 router (1 MB,
// 0.5 MB); about one multiply-add a byte, so it is a matrix-vector product
// bound by bytes, far below the 64 rows `wgmma` needs.  The design is about
// keeping the card's memory busy across three dependent phases:
//
// - Route: one 8-CTA cluster a token splits the router's rows; each CTA
//   (512 threads) sums its rows' products in f32 with every 16-byte load in
//   flight at once, so the router is read in one round trip.  The first CTA
//   adds the CTAs' sums in rank order through distributed shared memory,
//   takes the softmax, and the top K by rank (an expert's rank is the number
//   of experts with a larger p, or an equal p and a lower id: one pass over
//   the E probabilities by E threads at once), and writes ids and gates.
// - Gate/up: a CTA a (token slot, 64-column tile of F, slice of D), the
//   slices of one tile forming a cluster of 1-8 CTAs (the wrapper picks the
//   fewest that give about two CTAs an SM).  It reads its slot's expert id
//   on the device (nothing is sorted or gathered) and streams that
//   expert's gate and up columns, one 128-byte row segment each per 8
//   threads, 8 rows in flight a thread.  The row groups' partial sums meet
//   in shared memory, the slices' in the first CTA, which writes the slot's
//   bf16 SwiGLU tile.
// - Down and combine: a CTA a (token slot, 64-column tile of D), the K slots
//   of a token and tile forming one cluster.  Each streams its expert's down
//   columns over all F rows against the slot's SwiGLU row, rounds, gates;
//   the first CTA adds the K gated rows in slot order and writes bf16.
//
// Every sum has one fixed order (no atomics), so the same inputs give the
// same bits on every run, eager or replayed from a CUDA graph.  The three
// launches are programmatic: each may start while the one before it runs,
// and waits for it (griddepcontrol.wait) before it reads what that one
// wrote.  The gate/up kernel lets the down kernel start once the route
// kernel has finished, so the down kernel reads ids and gates and issues
// its first weight loads while the SwiGLU rows are still being made.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Nothing is allocated here; each launch is followed by cudaGetLastError(),
// whose code is returned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                    // columns a CTA owns (F or D)
constexpr int kChunks = kTile / 8;           // 16-byte pieces of a tile row
constexpr int kGroups = kThreads / kChunks;  // row groups of a CTA: 32
constexpr int kBatch = 8;          // rows a thread loads before it uses them
constexpr int kRouteThreads = 512;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kRouteCluster = 8;   // CTAs a token's router product spans
constexpr int kRouteBatch = 16;    // router rows a thread has in flight
constexpr int kMaxExperts = 256;
constexpr int kMaxTopK = 8;        // also the largest portable cluster
constexpr float kLow = -3.0e38f;   // below every logit

struct Params {
  const uint16_t* x;       // [T, D] bf16
  const float* router;     // [D, E] f32
  const uint16_t* w_gate;  // [E, D, F] bf16
  const uint16_t* w_up;    // [E, D, F]
  const uint16_t* w_down;  // [E, F, D]
  float* gates;            // [T, K] f32
  int32_t* ids;            // [T, K]
  uint16_t* h;             // [T * K, F] bf16 SwiGLU rows
  uint16_t* out;           // [T, D] bf16
  int d, e, k, f;
  int split;               // CTAs of a gate/up cluster (slices of D)
  int norm_topk;
};

// The route kernel's shared memory.
struct __align__(16) RouteSmem {
  float part[kRouteThreads * 4];  // [row groups][E] partial sums
  float mine[kMaxExperts];        // this CTA's sums over its rows
  float key[kMaxExperts];          // the probabilities, NaN as 2 (rank order)
  float red[2][kRouteWarps];
  float sel_p[kMaxTopK];
  int sel_id[kMaxTopK];
};

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint16_t f32_to_bf16_bits(float x) {
  // round to nearest even; a NaN becomes the one NaN torch's cast gives
  // (by a select: an early return here took the gate/up kernel from 64 to
  // 48 registers and fewer loads in flight, +9 us at deepseek's T = 1)
  const uint32_t u = __float_as_uint(x);
  const uint16_t r =
      static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
  return isnan(x) ? static_cast<uint16_t>(0x7fc0u) : r;
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

// Waits for the kernel before this one in the stream to finish and its
// writes to be visible (a no-op without a programmatic launch).
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Lets the next kernel in the stream start (it waits for this one before
// it reads what this one writes).
__device__ __forceinline__ void start_next_kernel() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ uint4 load16(const uint16_t* ptr) {
  return __ldg(reinterpret_cast<const uint4*>(ptr));
}

// acc[i] += xv * (the 8 bf16 values of w)[i]
__device__ __forceinline__ void fma8(float* acc, float xv, const uint4& w) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(xv, __uint_as_float(words[i] << 16), acc[2 * i]);
    acc[2 * i + 1] =
        fmaf(xv, __uint_as_float(words[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}

// The first CTA of token `tok`'s cluster: each thread e < E holds expert
// e's logit; the softmax, the top K by rank (larger p first, the lower
// expert id on equal p) and the gates, written to ids and gates.
__device__ void softmax_top_k(const Params& p, int tok, float logit,
                              RouteSmem& sm) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float wm = warp_max(logit);
  if (lane == 0) sm.red[0][warp] = wm;
  __syncthreads();
  float m = kLow;
#pragma unroll
  for (int w = 0; w < kRouteWarps; ++w) m = fmaxf(m, sm.red[0][w]);
  const float ex = tid < p.e ? expf(logit - m) : 0.f;
  const float ws = warp_sum(ex);
  if (lane == 0) sm.red[1][warp] = ws;
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < kRouteWarps; ++w) sum = __fadd_rn(sum, sm.red[1][w]);
  const float prob = __fdiv_rn(ex, sum);
  // The ranks are a permutation of 0 .. E-1 whatever x holds, so the K
  // slots are always filled with ids in [0, E).  A NaN or inf in x makes
  // every probability NaN (the sum is NaN); a NaN ranks above every number,
  // as torch.sort puts it, so all NaN probabilities are equal and ranked by
  // id, and the token's gates and output are NaN.
  const float key = isnan(prob) ? 2.f : prob;  // a probability is <= 1
  if (tid < p.e) sm.key[tid] = key;
  __syncthreads();
  if (tid < p.e) {
    int rank = 0;
    for (int j = 0; j < p.e; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(sm.key + j);
      rank += (q.x > key || (q.x == key && j < tid)) +
              (q.y > key || (q.y == key && j + 1 < tid)) +
              (q.z > key || (q.z == key && j + 2 < tid)) +
              (q.w > key || (q.w == key && j + 3 < tid));
    }
    if (rank < p.k) {
      sm.sel_p[rank] = prob;
      sm.sel_id[rank] = tid;
    }
  }
  __syncthreads();
  if (tid < p.k) {
    float total = 0.f;
    for (int j = 0; j < p.k; ++j) total = __fadd_rn(total, sm.sel_p[j]);
    const long long at = static_cast<long long>(tok) * p.k + tid;
    p.gates[at] = p.norm_topk ? __fdiv_rn(sm.sel_p[tid], total) : sm.sel_p[tid];
    p.ids[at] = sm.sel_id[tid];
  }
}

// Grid (kRouteCluster, T), one cluster a token: CTA r sums the products of
// router rows [r D / 8, (r + 1) D / 8); the first CTA adds the CTAs' sums
// and routes.
__global__ void __launch_bounds__(kRouteThreads)
    moe_route(const __grid_constant__ Params p) {
  __shared__ RouteSmem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tok = blockIdx.y, tid = threadIdx.x;
  const int n_chunk = p.e / 4, groups = kRouteThreads / n_chunk;
  const int c = tid % n_chunk, g = tid / n_chunk;
  const int rows = p.d / kRouteCluster, lo = rank * rows;
  const uint16_t* xt = p.x + static_cast<long long>(tok) * p.d + lo;
  const float* wr = p.router + static_cast<long long>(lo) * p.e + 4 * c;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (g < groups) {
    for (int base = g; base < rows; base += kRouteBatch * groups) {
      float4 w[kRouteBatch];
      float xv[kRouteBatch];
      // the router is a weight: its first rows are loaded while the
      // kernel before this one (which makes x) finishes
#pragma unroll
      for (int i = 0; i < kRouteBatch; ++i) {  // all in flight at once
        const int row = base + i * groups;
        if (row < rows)
          w[i] = __ldg(reinterpret_cast<const float4*>(
              wr + static_cast<long long>(row) * p.e));
      }
      if (base == g) wait_for_previous_kernel();
#pragma unroll
      for (int i = 0; i < kRouteBatch; ++i) {
        const int row = base + i * groups;
        if (row < rows) xv[i] = bf16_bits_to_f32(xt[row]);
      }
#pragma unroll
      for (int i = 0; i < kRouteBatch; ++i) {
        if (base + i * groups < rows) {
          acc[0] = fmaf(xv[i], w[i].x, acc[0]);
          acc[1] = fmaf(xv[i], w[i].y, acc[1]);
          acc[2] = fmaf(xv[i], w[i].z, acc[2]);
          acc[3] = fmaf(xv[i], w[i].w, acc[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm.part[g * p.e + 4 * c + i] = acc[i];
  }
  wait_for_previous_kernel();  // every thread, before anything is written
  start_next_kernel();
  __syncthreads();
  if (tid < p.e) {  // the row groups, in order
    float sum = 0.f;
    for (int j = 0; j < groups; ++j) sum = __fadd_rn(sum, sm.part[j * p.e + tid]);
    sm.mine[tid] = sum;
  }
  cluster.sync();
  if (rank == 0) {  // the logits: the CTAs' sums in rank order
    float logit = kLow;
    if (tid < p.e) {
      logit = 0.f;
      for (int q = 0; q < kRouteCluster; ++q)
        logit = __fadd_rn(logit, cluster.map_shared_rank(sm.mine, q)[tid]);
    }
    softmax_top_k(p, tok, logit, sm);
  }
  cluster.sync();  // no CTA leaves while the first reads its shared memory
}

// Grid (F / 64 · split, T · K): CTA (tile · split + r, pair) sums rows
// [r D / split, (r + 1) D / split) of the pair's expert's gate and up
// columns [64 tile, 64 tile + 64); the first CTA of the cluster adds the
// slices' sums and writes the SwiGLU tile.
__global__ void __launch_bounds__(kThreads)
    moe_gate_up(const __grid_constant__ Params p) {
  __shared__ float red[kGroups][2 * kTile + 1];  // padded against conflicts
  __shared__ float sums[2 * kTile];              // gate columns, then up
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / p.split, pair = blockIdx.y;
  const int tok = pair / p.k;
  const int tid = threadIdx.x, c = tid % kChunks, g = tid / kChunks;
  wait_for_previous_kernel();  // the route's ids
  start_next_kernel();  // the down kernel may read ids and gates from here
  const long long ex = p.ids[pair];
  const int rows = p.d / p.split, lo = rank * rows, hi = lo + rows;
  const long long col = static_cast<long long>(tile) * kTile + c * 8;
  const uint16_t* wg = p.w_gate + ex * p.d * p.f + col;
  const uint16_t* wu = p.w_up + ex * p.d * p.f + col;
  const uint16_t* xt = p.x + static_cast<long long>(tok) * p.d;
  float ag[8], au[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ag[i] = au[i] = 0.f;
  int r = lo + g;
  for (; r + (kBatch - 1) * kGroups < hi; r += kBatch * kGroups) {
    uint4 vg[kBatch], vu[kBatch];
    float xv[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const long long off = static_cast<long long>(r + i * kGroups) * p.f;
      vg[i] = load16(wg + off);
      vu[i] = load16(wu + off);
      xv[i] = bf16_bits_to_f32(xt[r + i * kGroups]);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      fma8(ag, xv[i], vg[i]);
      fma8(au, xv[i], vu[i]);
    }
  }
  for (; r < hi; r += kGroups) {
    const long long off = static_cast<long long>(r) * p.f;
    const float xv = bf16_bits_to_f32(xt[r]);
    fma8(ag, xv, load16(wg + off));
    fma8(au, xv, load16(wu + off));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[g][c * 8 + i] = ag[i];
    red[g][kTile + c * 8 + i] = au[i];
  }
  __syncthreads();
  if (tid < 2 * kTile) {  // the row groups, in order
    float sum = 0.f;
    for (int j = 0; j < kGroups; ++j) sum = __fadd_rn(sum, red[j][tid]);
    sums[tid] = sum;
  }
  cluster.sync();
  if (rank == 0 && tid < kTile) {  // the slices, in order
    float sg = 0.f, su = 0.f;
    for (int q = 0; q < p.split; ++q) {
      const float* other = cluster.map_shared_rank(sums, q);
      sg = __fadd_rn(sg, other[tid]);
      su = __fadd_rn(su, other[kTile + tid]);
    }
    const float gb = round_bf16(sg), ub = round_bf16(su);
    const float act = round_bf16(__fdiv_rn(gb, __fadd_rn(1.f, expf(-gb))));
    p.h[static_cast<long long>(pair) * p.f + tile * kTile + tid] =
        f32_to_bf16_bits(__fmul_rn(act, ub));
  }
  cluster.sync();  // no CTA leaves while the first reads its shared memory
}

// Grid (D / 64 · K, T): CTA (tile · K + j, tok) multiplies slot j's SwiGLU
// row by its expert's down columns [64 tile, 64 tile + 64) and gates it; the
// first CTA of the cluster adds the K slots in order.
__global__ void __launch_bounds__(kThreads)
    moe_down(const __grid_constant__ Params p) {
  extern __shared__ float hs[];  // [F] the slot's SwiGLU row
  __shared__ float red[kGroups][kTile + 1];
  __shared__ float gated[kTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int slot = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / p.k, tok = blockIdx.y;
  const int pair = tok * p.k + slot;
  const int tid = threadIdx.x, c = tid % kChunks, g = tid / kChunks;
  // The route finished before the gate/up kernel let this one start, so
  // its ids and gates are final; they are read from L2, past any stale L1,
  // and the first weight loads go out before the SwiGLU rows are ready.
  // (PTX promises visibility of the direct prerequisite's writes only after
  // griddepcontrol.wait; this read relies on the route's grid having
  // completed, which moe_decode_launch's comment sets out.)
  const long long ex = __ldcg(p.ids + pair);
  const float gate = __ldcg(p.gates + pair);
  const uint16_t* wd = p.w_down + ex * p.f * p.d +
                       static_cast<long long>(tile) * kTile + c * 8;
  uint4 first[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int row = g + i * kGroups;
    first[i] = row < p.f ? load16(wd + static_cast<long long>(row) * p.d)
                         : make_uint4(0u, 0u, 0u, 0u);
  }
  wait_for_previous_kernel();  // the SwiGLU rows
  const uint16_t* hrow = p.h + static_cast<long long>(pair) * p.f;
  for (int i = tid; i < p.f; i += kThreads) hs[i] = bf16_bits_to_f32(hrow[i]);
  __syncthreads();
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int row = g + i * kGroups;
    if (row < p.f) fma8(acc, hs[row], first[i]);
  }
  int r = g + kBatch * kGroups;
  for (; r + (kBatch - 1) * kGroups < p.f; r += kBatch * kGroups) {
    uint4 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      v[i] = load16(wd + static_cast<long long>(r + i * kGroups) * p.d);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) fma8(acc, hs[r + i * kGroups], v[i]);
  }
  for (; r < p.f; r += kGroups)
    fma8(acc, hs[r], load16(wd + static_cast<long long>(r) * p.d));
#pragma unroll
  for (int i = 0; i < 8; ++i) red[g][c * 8 + i] = acc[i];
  __syncthreads();
  if (tid < kTile) {  // the row groups in order, rounded and gated
    float sum = 0.f;
    for (int j = 0; j < kGroups; ++j) sum = __fadd_rn(sum, red[j][tid]);
    gated[tid] = round_bf16(__fmul_rn(round_bf16(sum), round_bf16(gate)));
  }
  cluster.sync();
  if (slot == 0 && tid < kTile) {  // the K slots, in order
    float sum = 0.f;
    for (int q = 0; q < p.k; ++q)
      sum = __fadd_rn(sum, cluster.map_shared_rank(gated, q)[tid]);
    p.out[static_cast<long long>(tok) * p.d + tile * kTile + tid] =
        f32_to_bf16_bits(sum);
  }
  cluster.sync();  // no CTA leaves while the first reads its shared memory
}

// A programmatic launch of `cluster`-CTA clusters along x.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int cluster,
                   size_t smem, cudaStream_t s, const Params& p) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// x [T, D] bf16, router [D, E] f32, w_gate and w_up [E, D, F] bf16, w_down
// [E, F, D] bf16, all contiguous; gates [T, K] f32, ids [T, K] int32, h
// [T · K, F] bf16 and out [T, D] bf16 are written.  `split` is the gate/up
// kernel's cluster size.  Returns a cudaError_t code.
//
// The down kernel reads ids and gates before its griddepcontrol.wait, so
// it relies on more than the PTX contract states: that the route grid's
// writes are visible to a grid that starts after the gate/up grid has
// returned from its own wait (which only happens once the route grid has
// completed and flushed its writes), though the route is not the down
// kernel's direct prerequisite.  On H100 this holds; the card tests and
// chip_smoke.py's phase 17 replay captured calls at T = 8 many times and
// hold each replay to the eager bits.
int moe_decode_launch(const void* x, const void* router, const void* w_gate,
                      const void* w_up, const void* w_down, void* gates,
                      void* ids, void* h, void* out, int t, int d, int e,
                      int k, int f, int split, int norm_topk, void* stream) {
  if (t < 1 || d < kTile || d % kTile != 0 || f < kTile || f % kTile != 0 ||
      e < 4 || e > kMaxExperts || e % 4 != 0 || k < 1 || k > kMaxTopK ||
      k > e || split < 1 || split > 8 || d % split != 0 ||
      static_cast<long long>(t) * k > 65535 || !aligned16(router) ||
      !aligned16(w_gate) || !aligned16(w_up) || !aligned16(w_down))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const uint16_t*>(x),
           static_cast<const float*>(router),
           static_cast<const uint16_t*>(w_gate),
           static_cast<const uint16_t*>(w_up),
           static_cast<const uint16_t*>(w_down),
           static_cast<float*>(gates),
           static_cast<int32_t*>(ids),
           static_cast<uint16_t*>(h),
           static_cast<uint16_t*>(out),
           d, e, k, f, split, norm_topk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t down_smem = static_cast<size_t>(f) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      moe_down, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(down_smem));
  if (err == cudaSuccess)
    err = launch(moe_route, dim3(kRouteCluster, t), kRouteThreads,
                 kRouteCluster, 0, s, p);
  if (err == cudaSuccess)
    err = launch(moe_gate_up, dim3(f / kTile * split, t * k), kThreads, split,
                 0, s, p);
  if (err == cudaSuccess)
    err = launch(moe_down, dim3(d / kTile * k, t), kThreads, k, down_smem, s,
                 p);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

const char* moe_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
