// Device helpers shared by the fused InstanceNorm + LeakyReLU kernels
// (fused_norm.cu: forward K1/K2; fused_norm_bwd.cu: backward K3/K4).
//
// Every kernel streams contiguous rows of a (rows, n) view of an NCDHW
// tensor: one block per (row, chunk of `chunk` elements), 256 threads, 16-byte
// vector accesses when the row length is a multiple of 8 and the pointers
// are 16-byte aligned, a scalar loop otherwise (the 125-element RFM5 rows).
// Offsets are 64-bit throughout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pnorm {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements per vector access; chunks are multiples

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back: the value a tensor of dtype T holds.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Eight consecutive elements: one 16-byte access for bf16, two for float.
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[kVec]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[kVec]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[kVec]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[kVec]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums a and b over the block; the totals are valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sh_a[kThreads / 32];
  __shared__ float sh_b[kThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sh_a[warp] = a;
    sh_b[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sh_a[lane] : 0.f;
    b = lane < kThreads / 32 ? sh_b[lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// The (row, [start, end)) slice that block `blk` streams.
struct Slice {
  int64_t row, start, end;
};

__device__ __forceinline__ Slice slice_of(int64_t blk, int64_t n,
                                          int64_t chunk, int64_t splits) {
  Slice s;
  s.row = blk / splits;
  s.start = (blk - s.row * splits) * chunk;
  s.end = min64(s.start + chunk, n);
  return s;
}

// Whether a launch over (rows, n) in chunks of `chunk` cannot be made: bad
// sizes, or more blocks than a one-dimensional grid takes.
inline bool bad_launch(int64_t rows, int64_t n, int64_t chunk) {
  if (rows <= 0 || n <= 0 || chunk <= 0 || chunk % kVec != 0) return true;
  return rows * ((n + chunk - 1) / chunk) > 0x7fffffff;
}

}  // namespace pnorm
