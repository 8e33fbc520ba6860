// EmbeddingBag for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `embedding_bag_pallas`
// (src/repro/kernels/embedding_bag/embedding_bag.py, body `_bag_kernel`).
// Given a table [V, E] (f32, or bf16 summed in f32), row ids idx [n]
// grouped by bag, optional weights w [n] and the bags' CSR offsets
// [n_bags + 1] (bag b owns positions offsets[b] .. offsets[b+1]-1), it
// writes, in the table's dtype,
//
//     out[b] = Σ_{offsets[b] <= i < offsets[b+1]} w[i] · table[idx[i]]
//
// divided by the bag's count in mean mode; a bag with no rows is zero.
// The wrapper (repro_torch/kernels/embedding_bag/ops.py) does the stable
// sort by segment and builds the offsets, as the JAX wrapper sorts.
//
// What bounds it.  At dlrm-rm2's bulk serving shape (262,144 bags of 26
// rows, E = 64, f32, a 48 GB table) the gathers read 256-byte rows from
// random places in the table: about 1.7 GB of rows, 0.08 GB of ids and
// segments and 0.07 GB of output, some 0.57 ms at 3.35 TB/s.  The
// multiply-adds do not bind.  So it is a random-gather, memory-bound
// kernel, and the design keeps many 16-byte loads in flight:
//
// - The TPU kernel walked n in order and revisited output rows.  Here a
//   warp owns a bag (a segmented reduction, no atomics): G lanes cover
//   one row's E columns with 16-byte loads (float4, or 8 bf16 in a
//   uint4), so a warp reads R = 32 / G rows at once, each lane slot
//   walking its rows in sorted order, and every slot loads kUnroll rows
//   before it adds any, so R * kUnroll gathers of a warp overlap.  A row
//   wider than 32 lanes' loads is split over blockIdx.y.
// - A bag's sum has a fixed order: slot r adds rows r, r + R, r + 2R...
//   (a separate multiply and add, no FMA contraction), then the R slots
//   combine in a fixed butterfly.  The same inputs give the same bits on
//   every run, and a one-row unweighted bag is its row bit for bit.
// - Row offsets are 64-bit: id * E * 4 passes 2^31 bytes in a 48 GB
//   table.  An id outside [0, V) stops the kernel with a trap, as a
//   device-side assert does.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Nothing is allocated here; every launch is followed by
// cudaGetLastError(), whose code is returned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // rows each lane slot loads before it adds

// VEC consecutive elements of a row at p, widened to f32.  VEC > 1 needs
// p 16-byte aligned (the launcher checks the base pointers and E).
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float* out);

template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

template <>
__device__ __forceinline__ void load_row<float, 1>(const float* p, float* out) {
  out[0] = __ldg(p);
}

// bf16 travels as its 16-bit pattern; widening to f32 is a shift.
template <>
__device__ __forceinline__ void load_row<uint16_t, 8>(const uint16_t* p,
                                                     float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // little-endian: element 2e is the low half
    out[2 * e] = __uint_as_float(words[e] << 16);
    out[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void load_row<uint16_t, 1>(const uint16_t* p,
                                                     float* out) {
  out[0] = __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// f32 -> bf16, round to nearest even, NaN -> 0x7fc0 (PyTorch's rule).
__device__ __forceinline__ uint32_t to_bf16(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p, const float* v);

template <>
__device__ __forceinline__ void store_row<float, 4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store_row<float, 1>(float* p, const float* v) {
  *p = v[0];
}

template <>
__device__ __forceinline__ void store_row<uint16_t, 8>(uint16_t* p,
                                                      const float* v) {
  uint4 o;
  o.x = to_bf16(v[0]) | (to_bf16(v[1]) << 16);
  o.y = to_bf16(v[2]) | (to_bf16(v[3]) << 16);
  o.z = to_bf16(v[4]) | (to_bf16(v[5]) << 16);
  o.w = to_bf16(v[6]) | (to_bf16(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = o;
}

template <>
__device__ __forceinline__ void store_row<uint16_t, 1>(uint16_t* p,
                                                      const float* v) {
  *p = static_cast<uint16_t>(to_bf16(v[0]));
}

// One warp per bag; G lanes (a power of two <= 32) per row, R = 32 / G
// row slots per warp; blockIdx.y picks the column chunk of G * VEC.
template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
bag_rows(const T* __restrict__ table, long long v, int e,
         const int32_t* __restrict__ idx, const float* __restrict__ w,
         const int64_t* __restrict__ offsets, int n_bags, int mean,
         T* __restrict__ out) {
  constexpr int R = 32 / G;
  const int lane = threadIdx.x & 31;
  const int slot = lane / G;
  const int col = blockIdx.y * (G * VEC) + (lane % G) * VEC;
  const bool active = col < e;  // VEC divides e, so the whole vector is in
  const long long bag =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // the whole warp leaves together
  const int64_t start = offsets[bag];
  const int64_t end = offsets[bag + 1];

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  for (int64_t base = start + slot; base < end;
       base += static_cast<int64_t>(R) * kUnroll) {
    bool has[kUnroll];
    int32_t id[kUnroll];
    float wt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * R;
      has[u] = i < end;
      id[u] = has[u] ? __ldg(idx + i) : 0;
      wt[u] = (has[u] && w != nullptr) ? __ldg(w + i) : 1.f;
      if (has[u] && (id[u] < 0 || static_cast<long long>(id[u]) >= v))
        __trap();
    }
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (has[u] && active) {
        load_row<T, VEC>(table + static_cast<size_t>(id[u]) * e + col, x[u]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) x[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!has[u]) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(x[u][j], wt[u]));
    }
  }
  // fixed butterfly over the R slots: lanes l and l ^ off add the same
  // two values, and float addition commutes, so both end with one sum
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
  }
  if (slot != 0 || !active) return;
  const int64_t count = end - start;
  if (mean && count > 0) {
    const float c = static_cast<float>(count);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fdiv_rn(acc[j], c);
  }
  store_row<T, VEC>(out + static_cast<size_t>(bag) * e + col, acc);
}

template <typename T, int VEC, int G>
int launch(const void* table, long long v, int e, const int32_t* idx,
           const float* w, const int64_t* offsets, int n_bags, int mean,
           void* out, cudaStream_t stream) {
  const int chunk = G * VEC;
  const dim3 grid((n_bags + kWarps - 1) / kWarps, (e + chunk - 1) / chunk);
  bag_rows<T, VEC, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(table), v, e, idx, w, offsets, n_bags, mean,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// G = the lanes a row's loads need, rounded up to a power of two, at most 32.
template <typename T, int VEC>
int launch_lanes(const void* table, long long v, int e, const int32_t* idx,
                 const float* w, const int64_t* offsets, int n_bags, int mean,
                 void* out, cudaStream_t s) {
  const int lanes = (e + VEC - 1) / VEC;
  if (lanes <= 1)
    return launch<T, VEC, 1>(table, v, e, idx, w, offsets, n_bags, mean, out, s);
  if (lanes <= 2)
    return launch<T, VEC, 2>(table, v, e, idx, w, offsets, n_bags, mean, out, s);
  if (lanes <= 4)
    return launch<T, VEC, 4>(table, v, e, idx, w, offsets, n_bags, mean, out, s);
  if (lanes <= 8)
    return launch<T, VEC, 8>(table, v, e, idx, w, offsets, n_bags, mean, out, s);
  if (lanes <= 16)
    return launch<T, VEC, 16>(table, v, e, idx, w, offsets, n_bags, mean, out, s);
  return launch<T, VEC, 32>(table, v, e, idx, w, offsets, n_bags, mean, out, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// dtype 0: table and out are f32; 1: bf16.  w may be null (unweighted).
// offsets has n_bags + 1 entries.  Returns a cudaError_t code.
int embedding_bag_launch(const void* table, long long v, int e, int dtype,
                         const int32_t* idx, const float* w,
                         const int64_t* offsets, int n_bags, int mean,
                         void* out, void* stream) {
  if (n_bags < 1 || e < 1 || v < 1 || (dtype != 0 && dtype != 1) ||
      (mean != 0 && mean != 1) ||
      (e + 31) / 32 > 65535)  // blockIdx.y chunks of the narrowest variant
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(table) && aligned16(out);
  if (dtype == 0) {
    if (aligned && e % 4 == 0)
      return launch_lanes<float, 4>(table, v, e, idx, w, offsets, n_bags,
                                    mean, out, s);
    return launch_lanes<float, 1>(table, v, e, idx, w, offsets, n_bags, mean,
                                  out, s);
  }
  if (aligned && e % 8 == 0)
    return launch_lanes<uint16_t, 8>(table, v, e, idx, w, offsets, n_bags,
                                     mean, out, s);
  return launch_lanes<uint16_t, 1>(table, v, e, idx, w, offsets, n_bags, mean,
                                   out, s);
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
