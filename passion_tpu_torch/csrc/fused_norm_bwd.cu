// Fused InstanceNorm + LeakyReLU for Hopper (sm_90a), backward: the two
// kernels of passion_tpu_torch/ops/fused_norm.py `norm_bwd_stats` (K3) and
// `norm_bwd_apply` (K4), behind a plain C interface loaded with ctypes.
//
// The JAX package has no kernel here: it differentiates the jnp version of
// the forward (passion_tpu/ops/fused_norm.py `_inl_jnp`, under the
// custom_jvp of `_inl`), whose gradient ops/norm.py:55-66 writes out:
//
//   x^ = (x - mean) * inv                   recomputed from x and K1's stats
//   g' = g, or g * slope where the forward's output was negative
//   dx = inv * (g' - mean(g') - x^ * mean(g' * x^))   means over the row
//
// The LeakyReLU branch is taken as `_inl_jnp` takes it: on x^ after its
// rounding to x's dtype, `>= 0` keeping slope 1; and g * slope is rounded
// to that dtype, with the slope itself in that dtype, as jnp computes it.
//
// What bounds them. Both are memory-bound, like K1/K2: K3 reads x and g
// once, K4 reads x and g once and writes dx once. The autograd wrapper
// saves only x and the (rows, 2) statistics, never y.
//
// K3 is built like K1: one partial record (sum g', sum g' x^) per (row,
// chunk), then a second launch that adds them per row in a fixed order in
// double, with no atomics, so runs repeat bit for bit. K4 is built like K2:
// one pass, 16-byte vector accesses on the contiguous path.

#include "norm_common.cuh"

namespace {

using namespace pnorm;

// g' of one element: g where round_T(x^) >= 0, else round_T(g * slope_T).
template <typename T>
__device__ __forceinline__ float slope_grad(float xh, float g,
                                            float slope_t) {
  return round_to<T>(xh) >= 0.f ? g : round_to<T>(g * slope_t);
}

// K3, first launch: block (row, split) sums g' and g' * x^ over its slice.
template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float2* __restrict__ stats, int64_t n,
                       int64_t chunk, int64_t splits, float slope,
                       float2* __restrict__ part) {
  const Slice sl = slice_of(blockIdx.x, n, chunk, splits);
  const int64_t off = sl.row * n;
  const float2 st = stats[sl.row];
  const float slope_t = round_to<T>(slope);

  float s = 0.f, sx = 0.f;
  if (kVectorized) {
    for (int64_t i = sl.start + static_cast<int64_t>(threadIdx.x) * kVec;
         i < sl.end; i += static_cast<int64_t>(kThreads) * kVec) {
      float xv[kVec], gv[kVec];
      Vec8<T>::load(x + off + i, xv);
      Vec8<T>::load(g + off + i, gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xh = (xv[j] - st.x) * st.y;
        const float gp = slope_grad<T>(xh, gv[j], slope_t);
        s += gp;
        sx = fmaf(gp, xh, sx);
      }
    }
  } else {
    for (int64_t i = sl.start + threadIdx.x; i < sl.end; i += kThreads) {
      const float xh = (to_float(x[off + i]) - st.x) * st.y;
      const float gp = slope_grad<T>(xh, to_float(g[off + i]), slope_t);
      s += gp;
      sx = fmaf(gp, xh, sx);
    }
  }

  block_sum2(s, sx);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(s, sx);
}

// K3, second launch: one thread per row adds its partials in split order in
// double and writes (mean(g'), mean(g' * x^)) as float.
__global__ void bwd_merge_kernel(const float2* __restrict__ part,
                                 int64_t rows, int64_t n, int64_t splits,
                                 float2* __restrict__ bstats) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  double s = 0.0, sx = 0.0;
  for (int64_t k = 0; k < splits; ++k) {
    const float2 p = part[row * splits + k];
    s += static_cast<double>(p.x);
    sx += static_cast<double>(p.y);
  }
  const double inv_n = 1.0 / static_cast<double>(n);
  bstats[row] = make_float2(static_cast<float>(s * inv_n),
                            static_cast<float>(sx * inv_n));
}

// K4: dx = inv * (g' - mean(g') - x^ * mean(g' * x^)), one rounding to T.
template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float2* __restrict__ stats,
                     const float2* __restrict__ bstats, T* __restrict__ dx,
                     int64_t n, int64_t chunk, int64_t splits, float slope) {
  const Slice sl = slice_of(blockIdx.x, n, chunk, splits);
  const int64_t off = sl.row * n;
  const float2 st = stats[sl.row];
  const float2 bs = bstats[sl.row];
  const float slope_t = round_to<T>(slope);

  if (kVectorized) {
    for (int64_t i = sl.start + static_cast<int64_t>(threadIdx.x) * kVec;
         i < sl.end; i += static_cast<int64_t>(kThreads) * kVec) {
      float xv[kVec], gv[kVec];
      Vec8<T>::load(x + off + i, xv);
      Vec8<T>::load(g + off + i, gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xh = (xv[j] - st.x) * st.y;
        const float gp = slope_grad<T>(xh, gv[j], slope_t);
        xv[j] = st.y * (gp - bs.x - xh * bs.y);
      }
      Vec8<T>::store(dx + off + i, xv);
    }
  } else {
    for (int64_t i = sl.start + threadIdx.x; i < sl.end; i += kThreads) {
      const float xh = (to_float(x[off + i]) - st.x) * st.y;
      const float gp = slope_grad<T>(xh, to_float(g[off + i]), slope_t);
      dx[off + i] = from_float<T>(st.y * (gp - bs.x - xh * bs.y));
    }
  }
}

template <typename T>
int launch_bwd_stats(const void* x, const void* g, const void* stats,
                     int64_t rows, int64_t n, int64_t chunk, int vectorized,
                     float slope, void* part, void* bstats,
                     cudaStream_t stream) {
  if (bad_launch(rows, n, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t splits = (n + chunk - 1) / chunk;
  const unsigned blocks = static_cast<unsigned>(rows * splits);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const float2* st = static_cast<const float2*>(stats);
  float2* pt = static_cast<float2*>(part);
  if (vectorized) {
    bwd_partial_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        xt, gt, st, n, chunk, splits, slope, pt);
  } else {
    bwd_partial_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        xt, gt, st, n, chunk, splits, slope, pt);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t merge_blocks = (rows + kThreads - 1) / kThreads;
  bwd_merge_kernel<<<static_cast<unsigned>(merge_blocks), kThreads, 0,
                     stream>>>(pt, rows, n, splits,
                               static_cast<float2*>(bstats));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_apply(const void* x, const void* g, const void* stats,
                     const void* bstats, void* dx, int64_t rows, int64_t n,
                     int64_t chunk, int vectorized, float slope,
                     cudaStream_t stream) {
  if (bad_launch(rows, n, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t splits = (n + chunk - 1) / chunk;
  const unsigned blocks = static_cast<unsigned>(rows * splits);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const float2* st = static_cast<const float2*>(stats);
  const float2* bs = static_cast<const float2*>(bstats);
  T* dt = static_cast<T*>(dx);
  if (vectorized) {
    bwd_apply_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        xt, gt, st, bs, dt, n, chunk, splits, slope);
  } else {
    bwd_apply_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        xt, gt, st, bs, dt, n, chunk, splits, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; x, g (and dx) share it. `vectorized` may
// be set only when n is a multiple of 8 and every row pointer is 16-byte
// aligned; `chunk` is a multiple of 8. `stats` holds K1's rows float2
// (mean, inv); `part` rows * ceil(n / chunk) float2; `bstats` rows float2
// (mean(g'), mean(g' * x^)). Each returns the cudaError_t of its launches.
extern "C" int pt_inl_bwd_stats(int dtype, const void* x, const void* g,
                                const void* stats, int64_t rows, int64_t n,
                                int64_t chunk, int vectorized, float slope,
                                void* part, void* bstats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd_stats<float>(x, g, stats, rows, n, chunk, vectorized,
                                   slope, part, bstats, s);
  }
  if (dtype == 1) {
    return launch_bwd_stats<__nv_bfloat16>(x, g, stats, rows, n, chunk,
                                           vectorized, slope, part, bstats,
                                           s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int pt_inl_bwd_apply(int dtype, const void* x, const void* g,
                                const void* stats, const void* bstats,
                                void* dx, int64_t rows, int64_t n,
                                int64_t chunk, int vectorized, float slope,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd_apply<float>(x, g, stats, bstats, dx, rows, n, chunk,
                                   vectorized, slope, s);
  }
  if (dtype == 1) {
    return launch_bwd_apply<__nv_bfloat16>(x, g, stats, bstats, dx, rows, n,
                                           chunk, vectorized, slope, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
