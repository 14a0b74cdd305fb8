// K5: exact squared Euclidean distance transform to a region's border, for
// Hopper (sm_90a), behind a plain C interface that
// passion_tpu_torch/ops/edt.py loads with ctypes.
//
// It is the port's own kernel, not a TPU port: it takes the place of the
// host's scipy `ndimage.distance_transform_edt(~border)` in HD95
// (passion_tpu/metrics.py:80, in `_surface_distances`), so that the 15-mask
// evaluation scores each case where the sweep left its labels.
//
// Input: a batch of uint8 label volumes (N, H, W, Z), Z contiguous, and a
// class set as a bit mask (bit c set: label c belongs to the region). The
// region's border is the region less its 6-neighbour erosion with voxels
// outside the volume counted as background (`ndimage.binary_erosion` with
// `generate_binary_structure(3, 1)` and border_value 0): a region voxel on
// a face of the volume is a border voxel. Output: int32, for every voxel
// the squared distance to the nearest border voxel of its volume, or
// INT32_MAX where the volume has no border voxel. Distances are integers up
// to (H-1)^2 + (W-1)^2 + (Z-1)^2 (137,958 for a 240x240x155 BraTS case),
// so every value is exact.
//
// The transform is separable (Meijster, Roerdink and Hesselink 2000): a
// 1-D distance along Z, then along W and along H the lower envelope of the
// parabolas (u - i)^2 + g(i) of each line, o(u) = min_i (u - i)^2 + g(i).
// Two launches, and no buffer besides the output:
//   A. border, Z and W: one block per (n, h) plane, whose W x Z labels are
//      contiguous. One thread copies the label planes h-1, h and h+1 into
//      shared memory with 1-D bulk copies (TMA, `cp.async.bulk`, completing
//      on an mbarrier; the few bytes before the first and after the last
//      16-byte boundary of a plane are copied by the threads). Each warp
//      tests 32 voxels of a Z row for the border at once and keeps one bit
//      each (`__ballot_sync`); each voxel finds the nearest border bit of
//      its row among those words (`__clz`, `__ffs`) and keeps the 1-D
//      distance in 16 bits, where the labels were. Then four threads a z
//      column run its W envelope on shared memory alone and write int32
//      once.
//   B. H, in place: a block loads the whole H lines of 32 consecutive
//      (w, z) offsets of a volume (one plane's W x Z values are
//      contiguous, so every row of the tile is one coalesced read; all of
//      them in flight at once with `cp.async`), runs their envelopes there
//      and writes the result over its input.
// An envelope is sequential along its line, so a line is shared by four
// lanes: each builds the envelope of the parabolas of a quarter of the
// line (its stack's top in registers, the rest in shared memory), then
// all four evaluate theirs at every point and two shuffles keep the least.
//
// What bounds it. The function reads N*V bytes of labels and writes 4*N*V
// bytes of distances (V = H*W*Z): 44.6 MB a 240x240x155 volume, 13.3 us at
// 3.35 TB/s. This design moves 13 bytes a voxel through device memory
// (pass A reads the labels, the neighbouring planes from L2, and writes
// int32; pass B reads and writes the int32), a floor of 2.6x the
// function's. What holds it far above that floor is the latency of the
// envelopes' steps. Each step of a line depends on the one before (a
// compare, and for a parabola kept an exact division: a float estimate
// corrected by multiply-compares), the 32 lines of a warp take different
// branches (a parabola dropped, kept or skipped), and shared memory caps
// the lines in flight: pass A's plane takes about 4 bytes a voxel (the
// three label planes, or the 16-bit distances and the envelopes' two
// indices a voxel), 154 KB at 240x155, so one block an SM; pass B's lines
// take 6 bytes a value, so 128 lines an SM. So the card holds too few
// lines to hide a step's latency, and the integer work, a few tens of
// operations a voxel, is far below its rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7fffffff;      // no border voxel in the volume
constexpr unsigned kNoBorder = 0xffff;  // 16-bit Z distance: none in the row
constexpr int64_t kMaxShared = 232448;  // a block's shared memory on sm_90
constexpr int kLanes = 4;          // threads that share an envelope's line
constexpr int kMaxThreadsA = 768;  // pass A's threads a block, at most
constexpr int kBLines = 32;        // pass B's lines a block

constexpr int64_t round16(int64_t x) { return (x + 15) / 16 * 16; }
constexpr int64_t larger(int64_t x, int64_t y) { return x > y ? x : y; }

// Pass A's shared memory for a W x Z plane (edt.py `_plan` computes the
// same): three label slots, each a plane and 16 bytes of alignment slack;
// over them, once the border is known, the 16-bit Z distances and the W
// envelopes' stacks (two S a voxel); then the border bits and the mbarrier.
struct LayoutA {
  int64_t slot, d, s, t, bits, bar, total;
};

template <typename S>
LayoutA layout_a(int64_t w, int64_t z) {
  const int64_t p = w * z, words = w * ((z + 31) / 32);
  const int64_t stack = round16(p * static_cast<int64_t>(sizeof(S)));
  LayoutA l;
  l.slot = round16(p + 16);
  l.d = 0;
  l.s = round16(2 * p);
  l.t = l.s + stack;
  l.bits = larger(3 * l.slot, l.t + stack);
  l.bar = l.bits + round16(4 * words);
  l.total = l.bar + 16;
  return l;
}

// Pass B's shared memory for kBLines lines of h values: g, then s and t.
template <typename S>
int64_t layout_b(int64_t h) {
  return kBLines * h * (4 + 2 * static_cast<int64_t>(sizeof(S)));
}

__device__ __forceinline__ bool in_region(unsigned v, unsigned classes) {
  return v < 32u && ((classes >> v) & 1u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// floor(num / den) for 0 <= num, 0 < den, num + den < 2^31: a float
// estimate, then made exact
__device__ __forceinline__ int floor_div(int num, int den) {
  int q = static_cast<int>(
      __fdividef(static_cast<float>(num), static_cast<float>(den)));
  while (q * den > num) --q;
  while ((q + 1) * den <= num) ++q;
  return q;
}

// g(w) of pass A's line at z: the squared 16-bit Z distance, or kInf
struct ZDistances {
  const uint16_t* d;
  int stride;
  __device__ __forceinline__ int operator()(int i) const {
    const unsigned v = d[i * stride];
    return v == kNoBorder ? kInf : static_cast<int>(v * v);
  }
};

// g(h) of pass B's line: its value in the block's tile
struct Tile {
  const int* g;
  int stride;
  __device__ __forceinline__ int operator()(int i) const {
    return g[i * stride];
  }
};

// One line of m values g(i) (kInf: no parabola), shared by kLanes
// consecutive lanes of a warp. Lane k of the group takes the parabolas
// (u - i)^2 + g(i) with vertices i in [k c, (k + 1) c), c = ceil(m /
// kLanes), and builds their lower envelope (Meijster, Roerdink and
// Hesselink 2000): a stack of vertices s and first points t where each is
// lowest, its top in registers, the entries below it in s[(k c + q) ss],
// t[(k c + q) ss]. Then each lane evaluates its envelope at every u from
// m - 1 down, the group takes the least of its kLanes values (shuffles),
// and its first lane writes o[u os] = min_i (u - i)^2 + g(i), exactly, or
// kInf where every g(i) is kInf. A lane whose group has no line (`live`
// false) holds no parabola and takes part in the shuffles only.
template <typename S, typename G>
__device__ __forceinline__ void envelope(int m, const G& g, S* s, S* t,
                                         int ss, int* o, int64_t os,
                                         bool live) {
  const int k = threadIdx.x & (kLanes - 1), c = (m + kLanes - 1) / kLanes;
  const int lo = min(m, k * c), hi = live ? min(m, lo + c) : lo;
  s += static_cast<int64_t>(lo) * ss;
  t += static_cast<int64_t>(lo) * ss;
  int q = -1, s_top = 0, t_top = 0, g_top = 0;
  int g_next = lo < hi ? g(lo) : kInf;
  for (int u = lo; u < hi; ++u) {
    const int gu = g_next;
    if (u + 1 < hi) g_next = g(u + 1);
    if (gu == kInf) continue;
    // drop the parabolas that u's lies below at the start of their segment
    while (q >= 0) {
      const int a = t_top - s_top, b = t_top - u;
      if (a * a + g_top <= b * b + gu) break;
      if (--q >= 0) {
        s_top = s[q * ss];
        t_top = t[q * ss];
        g_top = g(s_top);
      }
    }
    if (q < 0) {
      q = 0;
      s_top = u;
      t_top = 0;
      g_top = gu;
    } else {
      // first w where u's parabola is below s_top's: 1 + floor of their
      // crossing, whose numerator is >= 0 once the loop above has stopped
      const int w = 1 + floor_div(u * u - s_top * s_top + gu - g_top,
                                  2 * (u - s_top));
      if (w < m) {
        s[q * ss] = static_cast<S>(s_top);
        t[q * ss] = static_cast<S>(t_top);
        ++q;
        s_top = u;
        t_top = w;
        g_top = gu;
      }
    }
  }
  for (int u = m - 1; u >= 0; --u) {
    int v = kInf;
    if (q >= 0) {
      const int a = u - s_top;
      v = a * a + g_top;
    }
#pragma unroll
    for (int lane = 1; lane < kLanes; lane <<= 1) {
      v = min(v, __shfl_xor_sync(0xffffffffu, v, lane));
    }
    if (k == 0 && live) o[u * os] = v;
    if (u == t_top && q > 0) {
      --q;
      s_top = s[q * ss];
      t_top = t[q * ss];
      g_top = g(s_top);
    }
  }
}

// Pass A: block = one (n, h) plane; S indexes lines of W.
template <typename S>
__global__ void __launch_bounds__(kMaxThreadsA)
    edt_pass_a(const uint8_t* __restrict__ lab, int* __restrict__ out, int H,
               int W, int Z, unsigned classes, LayoutA lay) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int64_t plane = blockIdx.x;  // n * H + h
  const int h = static_cast<int>(plane % H);
  const int P = W * Z, nw = (Z + 31) / 32;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const uint32_t bar = smem_u32(sm + lay.bar);

  // stage planes h-1, h, h+1 (slots 0, 1, 2): byte g of a plane lands at
  // its slot + (g - floor16(the plane's first byte)), so the plane's
  // 16-byte-aligned middle is one bulk copy between aligned addresses, and
  // the threads copy the bytes before and after it
  const uint8_t* pl[3];
  uint32_t tx = 0;
  for (int i = 0; i < 3; ++i) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(lab + (plane + i - 1) * P);
    pl[i] = sm + i * lay.slot + (a & 15);
    const uintptr_t a0 = (a + 15) & ~uintptr_t(15), a1 = (a + P) & ~uintptr_t(15);
    const bool here = (i != 0 || h > 0) && (i != 2 || h < H - 1);
    if (here && a1 > a0) tx += static_cast<uint32_t>(a1 - a0);
  }
  if (tid == 0 && tx > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar),
                 "r"(tx)
                 : "memory");
  }
  for (int i = 0; i < 3; ++i) {
    if ((i == 0 && h == 0) || (i == 2 && h == H - 1)) continue;
    const uint8_t* src = lab + (plane + i - 1) * P;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a0 = (a + 15) & ~uintptr_t(15), a1 = (a + P) & ~uintptr_t(15);
    uint8_t* dst = const_cast<uint8_t*>(pl[i]);
    const int head = a1 > a0 ? static_cast<int>(a0 - a) : P;
    const int tail = a1 > a0 ? static_cast<int>(a1 - a) : P;
    if (tid == 0 && tail > head) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst + head)),
          "l"(src + head), "r"(tail - head), "r"(bar)
          : "memory");
    }
    for (int k = tid; k < head; k += nthreads) dst[k] = src[k];
    for (int k = tail + tid; k < P; k += nthreads) dst[k] = src[k];
  }
  __syncthreads();  // the barrier is initialised, the ends copied
  if (tx > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(0u)
          : "memory");
    }
  }

  // border bits: a warp takes a W row, 32 voxels along Z a word. A voxel
  // on a face has a background neighbour outside the volume: there the
  // neighbour read is the voxel itself, and `face` decides.
  uint32_t* bits = reinterpret_cast<uint32_t*>(sm + lay.bits);
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const uint8_t* mid = pl[1];
  const uint8_t* below = h > 0 ? pl[0] : mid;
  const uint8_t* above = h < H - 1 ? pl[2] : mid;
  for (int w = warp; w < W; w += nwarps) {
    const int back = w > 0 ? -Z : 0, front = w < W - 1 ? Z : 0;
    for (int k = 0; k < nw; ++k) {
      const int z = min(k * 32 + lane, Z - 1), i = w * Z + z;
      const bool face = h == 0 || h == H - 1 || w == 0 || w == W - 1 ||
                        z == 0 || z == Z - 1;
      const bool inner =
          in_region(below[i], classes) & in_region(above[i], classes) &
          in_region(mid[i + back], classes) &
          in_region(mid[i + front], classes) &
          in_region(mid[i - (z > 0)], classes) &
          in_region(mid[i + (z < Z - 1)], classes);
      const bool border = k * 32 + lane < Z && in_region(mid[i], classes) &&
                          (face || !inner);
      const uint32_t b = __ballot_sync(0xffffffffu, border);
      if (lane == 0) bits[w * nw + k] = b;
    }
  }
  __syncthreads();

  // 1-D distance along Z to the row's nearest border bit, over the labels
  uint16_t* d = reinterpret_cast<uint16_t*>(sm + lay.d);
  for (int w = warp; w < W; w += nwarps) {
    const uint32_t* row = bits + w * nw;
    for (int z = lane; z < Z; z += 32) {
      const int k = z >> 5, r = z & 31;
      int dist = kNoBorder;
      int j = k;
      uint32_t m = row[k] & (0xffffffffu >> (31 - r));  // bits <= z
      while (!m && j > 0) m = row[--j];
      if (m) dist = z - (j * 32 + 31 - __clz(m));
      j = k;
      m = row[k] & (0xffffffffu << r);  // bits >= z, while they can be nearer
      while (!m && j + 1 < nw && (j + 1) * 32 - z < dist) m = row[++j];
      if (m) dist = min(dist, j * 32 + __ffs(m) - 1 - z);
      d[w * Z + z] = static_cast<uint16_t>(dist);
    }
  }
  __syncthreads();

  // W envelope of each z column, kLanes threads a column, written once
  S* s = reinterpret_cast<S*>(sm + lay.s);
  S* t = reinterpret_cast<S*>(sm + lay.t);
  int* o = out + plane * P;
  const int groups = nthreads / kLanes;
  for (int z0 = 0; z0 < Z; z0 += groups) {
    const int z = z0 + tid / kLanes;
    const bool live = z < Z;
    const int c = live ? z : 0;
    envelope<S>(W, ZDistances{d + c, Z}, s + c, t + c, Z, o + c, Z, live);
  }
}

// Pass B: block = kBLines consecutive (w, z) offsets of one volume, each an
// H line of kLanes threads; the lines' values are the block's tile, and
// the envelopes write over their input.
template <typename S>
__global__ void __launch_bounds__(kBLines* kLanes)
    edt_pass_b(int* __restrict__ out, int H, int64_t P, int64_t tiles) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int tid = threadIdx.x;
  const int64_t n = blockIdx.x / tiles;
  const int64_t j0 = (blockIdx.x - n * tiles) * kBLines;
  const int width = static_cast<int>(P - j0 < kBLines ? P - j0 : kBLines);
  const int64_t cells = static_cast<int64_t>(H) * kBLines;
  int* g = reinterpret_cast<int*>(sm);
  S* s = reinterpret_cast<S*>(sm + 4 * cells);
  S* t = s + cells;
  int* base = out + n * H * P + j0;
  // every load of the tile in flight at once (cp.async), coalesced by row
  for (int i = tid; i < H * kBLines; i += blockDim.x) {
    const int u = i / kBLines, l = i % kBLines;
    if (l < width) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_u32(g + i)),
                   "l"(base + u * P + l)
                   : "memory");
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int l = tid / kLanes;
  envelope<S>(H, Tile{g + l, kBLines}, s + l, t + l, kBLines, base + l, P,
              l < width);
}

template <typename S>
cudaError_t launch_a(const uint8_t* lab, int* out, int64_t planes, int h,
                     int w, int z, unsigned classes, int threads,
                     int64_t shared, cudaStream_t st) {
  const LayoutA lay = layout_a<S>(w, z);
  if (lay.total > shared) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      edt_pass_a<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  edt_pass_a<S><<<static_cast<unsigned>(planes), threads,
                  static_cast<size_t>(shared), st>>>(lab, out, h, w, z,
                                                     classes, lay);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_b(int* out, int64_t n, int h, int64_t p, int64_t shared,
                     cudaStream_t st) {
  if (layout_b<S>(h) > shared) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      edt_pass_b<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const int64_t tiles = (p + kBLines - 1) / kBLines;
  edt_pass_b<S><<<static_cast<unsigned>(n * tiles), kBLines * kLanes,
                  static_cast<size_t>(shared), st>>>(out, h, p, tiles);
  return cudaGetLastError();
}

}  // namespace

// labels: (n, h, w, z) uint8, contiguous; classes: bit c set for label c in
// the region; out: (n, h, w, z) int32 on the same card. One launch of pass
// A over all n * h planes, then one of pass B over every volume. The launch
// geometry comes from edt.py `_plan`: pass A with `a_threads` threads (a
// multiple of 32, at most kMaxThreadsA) and `a_shared` bytes of shared
// memory, pass B (kBLines lines of kLanes threads a block) with `b_shared`
// bytes; each must hold the layout this file computes. Returns the
// cudaError_t of the launches (0 = success), cudaErrorInvalidValue for a
// shape or plan it does not take.
extern "C" int pt_edt_sq(const void* labels, int64_t n, int64_t h, int64_t w,
                         int64_t z, unsigned classes, int a_threads,
                         int64_t a_shared, int64_t b_shared, void* out,
                         void* stream) {
  if (n < 1 || h < 1 || w < 1 || z < 1 || h > 10000 || w > 10000 ||
      z > 10000 || a_threads < 32 || a_threads > kMaxThreadsA ||
      a_threads % 32 || a_shared > kMaxShared || b_shared > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* lab = static_cast<const uint8_t*>(labels);
  int* o = static_cast<int*>(out);
  const int hi = static_cast<int>(h), wi = static_cast<int>(w),
            zi = static_cast<int>(z);
  cudaError_t err =
      w <= 256 ? launch_a<uint8_t>(lab, o, n * h, hi, wi, zi, classes,
                                   a_threads, a_shared, st)
               : launch_a<uint16_t>(lab, o, n * h, hi, wi, zi, classes,
                                    a_threads, a_shared, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = h <= 256 ? launch_b<uint8_t>(o, n, hi, w * z, b_shared, st)
                 : launch_b<uint16_t>(o, n, hi, w * z, b_shared, st);
  return static_cast<int>(err);
}
