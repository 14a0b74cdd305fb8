// Fused InstanceNorm + LeakyReLU for Hopper (sm_90a), forward: the two
// kernels of passion_tpu_torch/ops/fused_norm.py `norm_stats` and
// `norm_apply`, behind a plain C interface that the wrapper loads with
// ctypes. The backward pair (K3, K4) is in fused_norm_bwd.cu.
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

#include "norm_common.cuh"

namespace {

using namespace pnorm;

// K1, first launch: block (row, split) reduces elements
// [split * chunk, min((split + 1) * chunk, n)) of its row to the pilot-
// shifted mean and the M2 of that slice.
template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    stats_partial_kernel(const T* __restrict__ x, int64_t n, int64_t chunk,
                         int64_t splits, float2* __restrict__ part) {
  const Slice sl = slice_of(blockIdx.x, n, chunk, splits);
  const T* base = x + sl.row * n;
  const float pilot = to_float(base[0]);

  float s = 0.f, s2 = 0.f;
  if (kVectorized) {
    for (int64_t i = sl.start + static_cast<int64_t>(threadIdx.x) * kVec;
         i < sl.end; i += static_cast<int64_t>(kThreads) * kVec) {
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
    for (int64_t i = sl.start + threadIdx.x; i < sl.end; i += kThreads) {
      const float d = to_float(base[i]) - pilot;
      s += d;
      s2 = fmaf(d, d, s2);
    }
  }

  block_sum2(s, s2);
  if (threadIdx.x == 0) {
    const float cnt = static_cast<float>(sl.end - sl.start);
    const float dmean = s / cnt;
    part[blockIdx.x] = make_float2(dmean, fmaxf(s2 - s * dmean, 0.f));
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
  const Slice sl = slice_of(blockIdx.x, n, chunk, splits);
  const int64_t off = sl.row * n;
  const float2 st = stats[sl.row];

  if (kVectorized) {
    for (int64_t i = sl.start + static_cast<int64_t>(threadIdx.x) * kVec;
         i < sl.end; i += static_cast<int64_t>(kThreads) * kVec) {
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
    for (int64_t i = sl.start + threadIdx.x; i < sl.end; i += kThreads) {
      const float t = (to_float(x[off + i]) - st.x) * st.y;
      y[off + i] = from_float<T>(t >= 0.f ? t : t * slope);
    }
  }
}

template <typename T>
int launch_stats(const void* x, int64_t rows, int64_t n, int64_t chunk,
                 int vectorized, float eps, void* part, void* stats,
                 cudaStream_t stream) {
  if (bad_launch(rows, n, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t splits = (n + chunk - 1) / chunk;
  const unsigned blocks = static_cast<unsigned>(rows * splits);
  const T* xt = static_cast<const T*>(x);
  float2* pt = static_cast<float2*>(part);
  if (vectorized) {
    stats_partial_kernel<T, true>
        <<<blocks, kThreads, 0, stream>>>(xt, n, chunk, splits, pt);
  } else {
    stats_partial_kernel<T, false>
        <<<blocks, kThreads, 0, stream>>>(xt, n, chunk, splits, pt);
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
  if (bad_launch(rows, n, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t splits = (n + chunk - 1) / chunk;
  const unsigned blocks = static_cast<unsigned>(rows * splits);
  const T* xt = static_cast<const T*>(x);
  const float2* st = static_cast<const float2*>(stats);
  T* yt = static_cast<T*>(y);
  if (vectorized) {
    apply_kernel<T, true>
        <<<blocks, kThreads, 0, stream>>>(xt, st, yt, n, chunk, splits, slope);
  } else {
    apply_kernel<T, false>
        <<<blocks, kThreads, 0, stream>>>(xt, st, yt, n, chunk, splits, slope);
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
