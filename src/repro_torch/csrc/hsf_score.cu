// Single-query HSF score for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `hsf_score_pallas`
// (src/repro/kernels/hsf_score/hsf_score.py, body `_hsf_kernel`).  For one
// query q [D] / qsig [W] against docs [N, D] / sigs [N, W] it writes
//
//     out[i] = alpha * (docs[i] . q) + beta * all((sigs[i] & qsig) == qsig)
//
// as f32 [N].  Docs and query are both f32 or both bf16; the dot
// accumulates in f32 either way.  The containment test compares the words
// as unsigned bit patterns (they carry the sign bit), and the boost is
// exactly beta.  A ragged N needs no padding: rows past N are never read.
//
// What bounds it.  At the serving shape (N = 65,536, D = 4,096, W = 128,
// f32) the kernel reads 1,073.7 MB of docs and 33.6 MB of signatures and
// writes 0.26 MB: 0.331 ms at 3.35 TB/s.  The 0.54 GFLOP of multiply-adds
// do not bind.  So it is a memory-bound GEMV plus a bitwise test, and the
// design spends its effort on keeping the loads wide and in flight:
//
// - One warp per doc row (a grid-stride loop over rows, as many CTAs as
//   fit on the card at once).  Each lane reads 16 bytes of the row at a
//   time (float4, or 8 bf16 in a uint4), neighbouring lanes on
//   neighbouring addresses, and the signature words one per lane.
// - The query (widened to f32) and its signature sit in shared memory,
//   loaded once per CTA; each lane reads its query slice as float4.
// - A row's score does not depend on N or on where the row sits: lane l
//   sums its elements l*VEC.., (l+32)*VEC.. in order with fmaf, then the
//   warp adds the 32 partials in a fixed butterfly.  The epilogue rounds
//   alpha*dot and beta*ind separately (no FMA contraction), as the plain
//   version does.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Nothing is allocated here; every launch is followed by
// cudaGetLastError(), whose code is returned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// bf16 travels as its 16-bit pattern; widening to f32 is a shift.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// VEC consecutive elements of a row at p, widened to f32.  VEC > 1 needs
// p 16-byte aligned (the launcher checks the base pointer and row pitch).
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
  out[0] = widen(p[0]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
hsf_score_rows(const T* __restrict__ docs, const uint32_t* __restrict__ sigs,
               const T* __restrict__ q, const uint32_t* __restrict__ qsig,
               int n, int d, int w, float alpha, float beta,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                                        // [d], f32
  uint32_t* sqs = reinterpret_cast<uint32_t*>(smem + d);  // [w]
  for (int i = threadIdx.x; i < d; i += kThreads) sq[i] = widen(q[i]);
  for (int i = threadIdx.x; i < w; i += kThreads) sqs[i] = qsig[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nvec = d / VEC;  // VEC divides d (launcher)
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < n;
       row += gridDim.x * kWarps) {
    const T* r = docs + static_cast<size_t>(row) * d;
    float acc = 0.f;
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      float x[VEC], y[VEC];
      load_row<T, VEC>(r + static_cast<size_t>(v) * VEC, x);
      if (VEC % 4 == 0) {
#pragma unroll
        for (int g = 0; g < VEC / 4; ++g) {
          const float4 qq = reinterpret_cast<const float4*>(sq)[v * (VEC / 4) + g];
          y[4 * g] = qq.x;
          y[4 * g + 1] = qq.y;
          y[4 * g + 2] = qq.z;
          y[4 * g + 3] = qq.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) y[e] = sq[v * VEC + e];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = fmaf(x[e], y[e], acc);
    }
    const uint32_t* s = sigs + static_cast<size_t>(row) * w;
    bool ok = true;
    for (int c = lane; c < w; c += 32) {
      const uint32_t qw = sqs[c];
      ok = ok && ((__ldg(s + c) & qw) == qw);
    }
    // fixed butterfly: lane a and lane a^off add the same two values,
    // and float addition commutes, so every lane ends with the same sum
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const bool all = __all_sync(0xffffffffu, ok);
    if (lane == 0)
      out[row] = __fadd_rn(__fmul_rn(alpha, acc),
                           __fmul_rn(beta, all ? 1.f : 0.f));
  }
}

template <typename T, int VEC>
int launch(const void* docs, const int32_t* sigs, const void* q,
           const int32_t* qsig, int n, int d, int w, float alpha, float beta,
           float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d + w) * sizeof(float);
  auto kern = hsf_score_rows<T, VEC>;
  cudaError_t err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_ctas = (static_cast<long long>(n) + kWarps - 1) / kWarps;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(rows_ctas < resident ? rows_ctas : resident);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(docs), reinterpret_cast<const uint32_t*>(sigs),
      static_cast<const T*>(q), reinterpret_cast<const uint32_t*>(qsig), n, d,
      w, alpha, beta, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Widest D + W the kernel takes (query and signature in shared memory).
int hsf_score_max_words() { return static_cast<int>(kMaxSmem / sizeof(float)); }

// dtype 0: docs and q are f32; 1: bf16.  Returns a cudaError_t code.
int hsf_score_launch(const void* docs, const int32_t* sigs, const void* q,
                     const int32_t* qsig, int n, int d, int w, int dtype,
                     float alpha, float beta, float* out, void* stream) {
  if (n < 1 || d < 0 || w < 0 || (dtype != 0 && dtype != 1) ||
      static_cast<size_t>(d + w) * sizeof(float) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(docs) & 15u) == 0;
  if (dtype == 0) {
    if (aligned && d % 4 == 0)
      return launch<float, 4>(docs, sigs, q, qsig, n, d, w, alpha, beta, out, s);
    return launch<float, 1>(docs, sigs, q, qsig, n, d, w, alpha, beta, out, s);
  }
  if (aligned && d % 8 == 0)
    return launch<uint16_t, 8>(docs, sigs, q, qsig, n, d, w, alpha, beta, out, s);
  return launch<uint16_t, 1>(docs, sigs, q, qsig, n, d, w, alpha, beta, out, s);
}

const char* hsf_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
