// Reflect padding of the three spatial axes for Hopper (sm_90a): K6, the
// kernel of passion_tpu_torch/ops/pad.py `reflect_pad3d`, behind a plain C
// interface that the wrapper loads with ctypes.
//
// It is the port's own kernel, not a port of a TPU kernel. The JAX package
// pads with `jnp.pad(mode="reflect")` in front of every reflect-padded conv
// (passion_tpu/models/layers.py:178-182) and leaves it to XLA; the port
// padded with `F.pad(mode="reflect")`, whose reflection_pad3d kernel moved
// its bytes at about a tenth of the card's HBM rate and took 0.14-0.20 of
// the sweeps' device time.
//
// What it computes. y = x padded by `pad` on each side of D, H and W with
// numpy's "reflect" indices, for a contiguous (P, D, H, W) input (P = N * C
// planes) and any sizes, `pad >= size` included: an output coordinate o of
// an axis of n voxels reads i = o - pad reflected periodically, 0 when
// n == 1, else j = |i| mod 2(n - 1) and 2(n - 1) - j where j >= n. It is a
// copy, so it moves raw 2-, 4- or 8-byte words and equals F.pad bit for
// bit.
//
// What bounds it. Nothing but bytes: each input element is read once (the
// halo again, from cache) and each output element written once. So each
// thread owns kVec consecutive elements of the flat output (16 bytes) and
// stores them with one vector store; an output row of 82 bf16 is 164 bytes,
// so tying a thread to a row would leave stores narrow and unaligned. A run
// that lies inside the interior of one output row reads kVec consecutive
// input elements through the read-only cache. A run that touches a row's
// halo or crosses into the next row (a fifth of bf16 runs at 82 a row, each
// diverging from its warp's interior runs) computes each element on its
// own from two row bases, where the pad is shorter than every axis and a
// run spans at most two rows; otherwise (an axis of at most the pad, or
// rows shorter than a run) it walks its elements one by one with the
// periodic index. Indices within a
// launch are 32-bit (divisions by the padded extents are multiply-shifts
// with host-computed magic numbers); plane offsets are 64-bit, since at
// (75, 32, 82^3) bf16 the output holds 2.58 GB. A tensor of more than
// 2^31 - 1 output elements is cut into launches of whole planes.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdlib>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxElems = (int64_t{1} << 31) - 1;  // output of a launch

// n / d for n < 2^31 and 1 <= d < 2^31, as a multiply-high, an add and a
// shift (the round-up method of Granlund and Montgomery, as PyTorch's
// IntDivider): shift = ceil(log2 d), magic = 2^32 (2^shift - d) / d + 1.
struct FastDiv {
  uint32_t d, magic, shift;
};

FastDiv make_div(uint32_t d) {
  uint32_t shift = 0;
  while ((uint32_t{1} << shift) < d) ++shift;
  const uint64_t one = 1;
  const uint64_t magic = ((one << 32) * ((one << shift) - d)) / d + 1;
  return FastDiv{d, static_cast<uint32_t>(magic), shift};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.magic) + n) >> f.shift;
}

struct Geometry {
  FastDiv plane, hw, w;  // output elements of a plane, of a D-slice, a row
  int D, H, W, Dp, Hp, Wp, pad;
  int64_t in_plane;  // input elements of a plane
  // pad < D, H, W and a run spans at most two output rows: a halo run's
  // elements each take one of two row bases and a mirror without a modulo
  bool two_rows;
};

// numpy's "reflect" index of i on an axis of n voxels, for any i
__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  const int m = 2 * (n - 1);
  int j = abs(i);
  if (j >= m) j %= m;
  return j >= n ? m - j : j;
}

// input offset, within its plane, of the row that output row (d, h) copies
__device__ __forceinline__ int row_of(int d, int h, const Geometry& g) {
  return (reflect(d - g.pad, g.D) * g.H + reflect(h - g.pad, g.H)) * g.W;
}

// one 16-byte store of a thread's run
__device__ __forceinline__ void store16(uint16_t* out,
                                        const uint16_t (&v)[8]) {
  uint4 q;
  q.x = v[0] | (static_cast<uint32_t>(v[1]) << 16);
  q.y = v[2] | (static_cast<uint32_t>(v[3]) << 16);
  q.z = v[4] | (static_cast<uint32_t>(v[5]) << 16);
  q.w = v[6] | (static_cast<uint32_t>(v[7]) << 16);
  *reinterpret_cast<uint4*>(out) = q;
}

__device__ __forceinline__ void store16(uint32_t* out,
                                        const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(out) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(uint64_t* out,
                                        const uint64_t (&v)[2]) {
  *reinterpret_cast<ulonglong2*>(out) = make_ulonglong2(v[0], v[1]);
}

// K6: thread t writes output elements [t * kVec, t * kVec + kVec) of a
// launch's `total`, U the element's bits (uint16_t: bf16, uint32_t: fp32,
// uint64_t: fp64)
template <typename U>
__global__ void __launch_bounds__(kThreads)
    reflect_pad3d_kernel(const U* __restrict__ x, U* __restrict__ y,
                         uint32_t total, Geometry g) {
  constexpr int kVec = 16 / sizeof(U);
  const uint32_t e0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (e0 >= total) return;
  const uint32_t plane = divide(e0, g.plane);
  uint32_t r = e0 - plane * g.plane.d;
  int d = static_cast<int>(divide(r, g.hw));
  r -= static_cast<uint32_t>(d) * g.hw.d;
  int h = static_cast<int>(divide(r, g.w));
  int w = static_cast<int>(r - static_cast<uint32_t>(h) * g.w.d);
  const U* src = x + static_cast<int64_t>(plane) * g.in_plane;
  const U* row = src + row_of(d, h, g);
  const bool whole = e0 + kVec <= total;

  U v[kVec];
  if (whole && w >= g.pad && w + kVec <= g.W + g.pad) {
    const U* s = row + (w - g.pad);  // the interior of one row
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = __ldg(s + k);
  } else if (g.two_rows) {
    // the output row after this one: the next H row, D-slice or plane
    int h1 = h + 1, d1 = d;
    const U* src1 = src;
    if (h1 == g.Hp) {
      h1 = 0;
      if (++d1 == g.Dp) {
        d1 = 0;
        src1 += g.in_plane;
      }
    }
    const U* row1 = src1 + row_of(d1, h1, g);
    // each element on its own (no chain from one to the next)
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const bool next = w + k >= g.Wp;
      int i = (next ? w + k - g.Wp : w + k) - g.pad;
      i = i < 0 ? -i : (i >= g.W ? 2 * (g.W - 1) - i : i);
      v[k] = e0 + k < total ? __ldg((next ? row1 : row) + i) : U(0);
    }
  } else {  // short axes: walk the elements with numpy's periodic index
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      v[k] = e0 + k < total ? __ldg(row + reflect(w - g.pad, g.W)) : U(0);
      if (++w == g.Wp) {  // the next row, D-slice or plane
        w = 0;
        if (++h == g.Hp) {
          h = 0;
          if (++d == g.Dp) {
            d = 0;
            src += g.in_plane;
          }
        }
        row = src + row_of(d, h, g);
      }
    }
  }

  U* out = y + e0;
  if (whole && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    store16(out, v);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (e0 + k < total) out[k] = v[k];
    }
  }
}

template <typename U>
int launch(const void* x, void* y, int64_t planes, int64_t D, int64_t H,
           int64_t W, int64_t pad, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(U);
  const int64_t Dp = D + 2 * pad, Hp = H + 2 * pad, Wp = W + 2 * pad;
  const int64_t out_plane = Dp * Hp * Wp;
  Geometry g;
  g.plane = make_div(static_cast<uint32_t>(out_plane));
  g.hw = make_div(static_cast<uint32_t>(Hp * Wp));
  g.w = make_div(static_cast<uint32_t>(Wp));
  g.D = static_cast<int>(D);
  g.H = static_cast<int>(H);
  g.W = static_cast<int>(W);
  g.Dp = static_cast<int>(Dp);
  g.Hp = static_cast<int>(Hp);
  g.Wp = static_cast<int>(Wp);
  g.pad = static_cast<int>(pad);
  g.in_plane = D * H * W;
  g.two_rows = pad < D && pad < H && pad < W && Wp >= kVec;
  // whole planes a launch; a multiple of 8 where it can be, so that every
  // launch's output starts 16-byte aligned whatever the plane's size
  int64_t group = kMaxElems / out_plane;
  if (group >= 8) group -= group % 8;
  const U* xs = static_cast<const U*>(x);
  U* ys = static_cast<U*>(y);
  for (int64_t p0 = 0; p0 < planes; p0 += group) {
    const int64_t n = planes - p0 < group ? planes - p0 : group;
    const int64_t total = n * out_plane;
    const int64_t threads = (total + kVec - 1) / kVec;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    reflect_pad3d_kernel<U><<<blocks, kThreads, 0, stream>>>(
        xs + p0 * g.in_plane, ys + p0 * out_plane,
        static_cast<uint32_t>(total), g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float64. x is a contiguous
// (planes, D, H, W) tensor, y a contiguous (planes, D + 2 pad, H + 2 pad,
// W + 2 pad) one.
// Returns the cudaError_t of its launches (0 = success); sizes it does not
// take (an empty axis, a negative pad, a padded plane of 2^31 - 1 elements
// or more) return cudaErrorInvalidValue without a launch.
extern "C" int pt_reflect_pad3d(int dtype, const void* x, void* y,
                                int64_t planes, int64_t D, int64_t H,
                                int64_t W, int64_t pad, void* stream) {
  if (planes < 0 || D < 1 || H < 1 || W < 1 || pad < 0 ||
      (D + 2 * pad) * (H + 2 * pad) * (W + 2 * pad) > kMaxElems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<uint32_t>(x, y, planes, D, H, W, pad, s);
  if (dtype == 1) return launch<uint16_t>(x, y, planes, D, H, W, pad, s);
  if (dtype == 2) return launch<uint64_t>(x, y, planes, D, H, W, pad, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
