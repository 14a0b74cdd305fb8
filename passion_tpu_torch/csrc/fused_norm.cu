// Fused InstanceNorm + LeakyReLU for Hopper (sm_90a): the two kernels of
// passion_tpu_torch/ops/fused_norm.py, behind a plain C interface that the
// wrapper loads with ctypes.
//
// K1 (stats) replaces passion_tpu/ops/fused_norm.py `_stats_kernel` and the
// host glue of `_pallas_norm_lrelu` that turns its lane moments into
// per-(batch, channel) mean and rsqrt(var + eps). K2 (apply) replaces
// `_make_apply_kernel` / `_apply_kernel`.
//
// Layout. The input is a contiguous (B, C, S) tensor. A statistics group is
// `phase_group` adjacent channels of one batch element, which is one
// contiguous row of n = phase_group * S elements; there are
// rows = B * C / phase_group of them. Every offset is 64-bit: the hoisted
// scale-1 norm of the sweep sees 75 * 32 * 80^3 = 1.23e9 elements.
//
// What bounds them. Both passes are memory-bound on an H100 (3.35 TB/s,
// ~3 flops per element against ~295 flops per byte of balance): K1 reads
// the tensor once, K2 reads it once and writes it once. So each block
// streams a contiguous chunk of one row with 16-byte vector accesses and
// keeps every intermediate in registers.
//
// Where the TPU kernel carried its sums across the sequential grid axis,
// blocks here run in no order. K1 therefore writes one partial record per
// (row, chunk) and a second launch merges them with Chan's formula in a
// fixed order, in double precision, with no atomics: runs repeat bit for
// bit. Partial sums are shifted by a per-row pilot (the row's first value)
// so E[x^2] - E[x]^2 never cancels when |mean| >> std.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// K1, first launch: block (row, split) reduces elements
// [split * chunk, min((split + 1) * chunk, n)) of its row to the pilot-
// shifted mean and the M2 of that slice.
template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    stats_partial_kernel(const T* __restrict__ x, int64_t n, int64_t chunk,
                         int64_t splits, float2* __restrict__ part) {
  const int64_t blk = blockIdx.x;
  const int64_t row = blk / splits;
  const int64_t start = (blk - row * splits) * chunk;
  const int64_t end = min64(start + chunk, n);
  const T* base = x + row * n;
  const float pilot = to_float(base[0]);

  float s = 0.f, s2 = 0.f;
  if (kVectorized) {
    for (int64_t i = start + static_cast<int64_t>(threadIdx.x) * kVec;
         i < end; i += static_cast<int64_t>(kThreads) * kVec) {
      float v[kVec];
      Vec8<T>::load(base + i, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v[j] - pilot;
        s += d;
        s2 = fmaf(d, d, s2);
      }
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
      const float d = to_float(base[i]) - pilot;
      s += d;
      s2 = fmaf(d, d, s2);
    }
  }

  __shared__ float sh_s[kThreads / 32];
  __shared__ float sh_s2[kThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    sh_s[warp] = s;
    sh_s2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? sh_s[lane] : 0.f;
    s2 = lane < kThreads / 32 ? sh_s2[lane] : 0.f;
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float cnt = static_cast<float>(end - start);
      const float dmean = s / cnt;
      part[blk] = make_float2(dmean, fmaxf(s2 - s * dmean, 0.f));
    }
  }
}

// K1, second launch: one thread per row merges its partials in split order
// (Chan's parallel-variance formula, double precision) and writes
// (mean, rsqrt(var + eps)) as float.
template <typename T>
__global__ void stats_merge_kernel(const T* __restrict__ x,
                                   const float2* __restrict__ part,
                                   int64_t rows, int64_t n, int64_t chunk,
                                   int64_t splits, float eps,
                                   float2* __restrict__ stats) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  double cnt = 0.0, mean = 0.0, m2 = 0.0;
  for (int64_t k = 0; k < splits; ++k) {
    const float2 p = part[row * splits + k];
    const double nb = static_cast<double>(min64(chunk, n - k * chunk));
    const double tot = cnt + nb;
    const double delta = static_cast<double>(p.x) - mean;
    mean += delta * (nb / tot);
    m2 += static_cast<double>(p.y) + delta * delta * (cnt * nb / tot);
    cnt = tot;
  }
  const double pilot = static_cast<double>(to_float(x[row * n]));
  const double var = m2 / cnt;
  stats[row] = make_float2(static_cast<float>(pilot + mean),
                           static_cast<float>(1.0 / sqrt(var + eps)));
}

// K2: y = (x - mean) * inv (not x * scale + shift, which cancels two
// O(|mean| * inv) terms), LeakyReLU in float, one rounding to T.
template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, const float2* __restrict__ stats,
                 T* __restrict__ y, int64_t n, int64_t chunk, int64_t splits,
                 float slope) {
  const int64_t blk = blockIdx.x;
  const int64_t row = blk / splits;
  const int64_t start = (blk - row * splits) * chunk;
  const int64_t end = min64(start + chunk, n);
  const int64_t off = row * n;
  const float2 st = stats[row];

  if (kVectorized) {
    for (int64_t i = start + static_cast<int64_t>(threadIdx.x) * kVec;
         i < end; i += static_cast<int64_t>(kThreads) * kVec) {
      float v[kVec];
      Vec8<T>::load(x + off + i, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float t = (v[j] - st.x) * st.y;
        v[j] = t >= 0.f ? t : t * slope;
      }
      Vec8<T>::store(y + off + i, v);
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
      const float t = (to_float(x[off + i]) - st.x) * st.y;
      y[off + i] = from_float<T>(t >= 0.f ? t : t * slope);
    }
  }
}

template <typename T>
int launch_stats(const void* x, int64_t rows, int64_t n, int64_t chunk,
                 int vectorized, float eps, void* part, void* stats,
                 cudaStream_t stream) {
  const int64_t splits = (n + chunk - 1) / chunk;
  const int64_t blocks = rows * splits;
  if (rows <= 0 || n <= 0 || chunk % kVec != 0 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* xt = static_cast<const T*>(x);
  float2* pt = static_cast<float2*>(part);
  if (vectorized) {
    stats_partial_kernel<T, true>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            xt, n, chunk, splits, pt);
  } else {
    stats_partial_kernel<T, false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            xt, n, chunk, splits, pt);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t merge_blocks = (rows + kThreads - 1) / kThreads;
  stats_merge_kernel<T>
      <<<static_cast<unsigned>(merge_blocks), kThreads, 0, stream>>>(
          xt, pt, rows, n, chunk, splits, eps, static_cast<float2*>(stats));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* x, const void* stats, void* y, int64_t rows,
                 int64_t n, int64_t chunk, int vectorized, float slope,
                 cudaStream_t stream) {
  const int64_t splits = (n + chunk - 1) / chunk;
  const int64_t blocks = rows * splits;
  if (rows <= 0 || n <= 0 || chunk % kVec != 0 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* xt = static_cast<const T*>(x);
  const float2* st = static_cast<const float2*>(stats);
  T* yt = static_cast<T*>(y);
  if (vectorized) {
    apply_kernel<T, true>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            xt, st, yt, n, chunk, splits, slope);
  } else {
    apply_kernel<T, false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            xt, st, yt, n, chunk, splits, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `vectorized` may be set only when n is a
// multiple of 8 and x (and y) are 16-byte aligned; `chunk` is a multiple of
// 8. `part` holds rows * ceil(n / chunk) float2, `stats` rows float2
// (mean, inv). Each returns the cudaError_t of its launches (0 = success).
extern "C" int pt_inl_stats(int dtype, const void* x, int64_t rows, int64_t n,
                            int64_t chunk, int vectorized, float eps,
                            void* part, void* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_stats<float>(x, rows, n, chunk, vectorized, eps, part,
                               stats, s);
  }
  if (dtype == 1) {
    return launch_stats<__nv_bfloat16>(x, rows, n, chunk, vectorized, eps,
                                       part, stats, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int pt_inl_apply(int dtype, const void* x, const void* stats,
                            void* y, int64_t rows, int64_t n, int64_t chunk,
                            int vectorized, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_apply<float>(x, stats, y, rows, n, chunk, vectorized, slope,
                               s);
  }
  if (dtype == 1) {
    return launch_apply<__nv_bfloat16>(x, stats, y, rows, n, chunk,
                                       vectorized, slope, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
