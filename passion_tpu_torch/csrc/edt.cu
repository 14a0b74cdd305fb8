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
// Three passes, each a launch (separable, after Meijster, Roerdink and
// Hesselink 2000):
//   1. along Z: one block per (n, h, w) line, one thread per voxel. Each
//      thread tests its voxel for the border (its own label and its six
//      neighbours'; the border is never stored), then two block-wide scans
//      give the nearest border voxel before and after it on the line, and
//      the thread writes the squared 1-D distance. Labels are read with
//      neighbouring threads on neighbouring bytes.
//   2. along W, 3. along H: one thread per line, neighbouring threads on
//      neighbouring z, so every access is coalesced. Each thread builds the
//      lower envelope of the parabolas (u - i)^2 + g(i) of its line in
//      integer arithmetic, with the envelope's vertices and starts in
//      shared memory (one byte each for lines of up to 256 voxels), then
//      writes min_i (u - i)^2 + g(i) for every u. Pass 2 reads the output
//      and writes `tmp`, pass 3 reads `tmp` and writes the output.
//
// What bounds it: memory. The function reads N*V bytes of labels and writes
// 4*N*V bytes of distances (V = H*W*Z); at N x 240x240x155 that is 44.6 MB
// per volume, 13.3 us at 3.35 TB/s. The three passes move about 29 bytes a
// voxel instead of 5: pass 1 reads the labels (a voxel's six neighbours
// come from lines that L1 and L2 hold) and writes 4 bytes, passes 2 and 3
// each read 4 and write 4, and each envelope reads g again at its vertices
// (cached), so the design's own floor is about 5.8x the function's. The
// integer work is a few tens of operations a voxel, far below the card's
// rate. Passes 2 and 3 run one line per thread at most ~450 threads an SM
// (the envelope's 2 bytes a voxel in shared memory), so they are bound by
// the latency of their loads rather than by bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7fffffff;  // no border voxel in the volume
constexpr int kFar = 1 << 30;     // no border voxel on this side of a line
constexpr int kLineThreads = 64;  // threads (lines) per block, passes 2, 3
constexpr int kMaxScanLine = 1024;  // pass 1: one thread per voxel of a line
constexpr int kMaxShared = 48 * 1024;  // static limit, no opt-in needed

__device__ __forceinline__ bool in_region(const uint8_t* __restrict__ lab,
                                          int64_t i, unsigned classes) {
  const unsigned v = lab[i];
  return v < 32u && ((classes >> v) & 1u);
}

// Pass 1: block = one (n, h, w) line along Z, blockDim.x >= Z threads (a
// multiple of 32). Shared memory: 2 * blockDim.x ints.
__global__ void border_scan_z(const uint8_t* __restrict__ lab,
                              int* __restrict__ out, int H, int W, int Z,
                              unsigned classes) {
  extern __shared__ int scan[];
  int* before = scan;               // nearest border index <= z, or -kFar
  int* after = scan + blockDim.x;   // nearest border index >= z, or kFar
  const int64_t line = blockIdx.x;  // (n * H + h) * W + w
  const int w = static_cast<int>(line % W);
  const int h = static_cast<int>((line / W) % H);
  const int z = threadIdx.x;
  const int64_t i = line * Z + z;
  const int64_t sw = Z, sh = static_cast<int64_t>(W) * Z;

  bool border = false;
  if (z < Z && in_region(lab, i, classes)) {
    // a voxel on a face has a background neighbour outside the volume;
    // `||` stops before any read outside it
    border = h == 0 || h == H - 1 || w == 0 || w == W - 1 || z == 0 ||
             z == Z - 1 || !in_region(lab, i - 1, classes) ||
             !in_region(lab, i + 1, classes) ||
             !in_region(lab, i - sw, classes) ||
             !in_region(lab, i + sw, classes) ||
             !in_region(lab, i - sh, classes) ||
             !in_region(lab, i + sh, classes);
  }
  before[z] = border ? z : -kFar;
  after[z] = border ? z : kFar;
  __syncthreads();
  // inclusive max-scan of `before` forwards, min-scan of `after` backwards
  for (int off = 1; off < static_cast<int>(blockDim.x); off <<= 1) {
    const int b = z >= off ? before[z - off] : -kFar;
    const int a = z + off < static_cast<int>(blockDim.x) ? after[z + off]
                                                         : kFar;
    __syncthreads();
    before[z] = max(before[z], b);
    after[z] = min(after[z], a);
    __syncthreads();
  }
  if (z < Z) {
    const int db = before[z] >= 0 ? z - before[z] : kFar;
    const int da = after[z] < kFar ? after[z] - z : kFar;
    const int d = min(db, da);
    out[i] = d >= kFar ? kInf : d * d;
  }
}

// One line of `m` values g(i) at stride `stride` (kInf: no parabola):
// o(u) = min_i (u - i)^2 + g(i), exactly, or kInf when every g(i) is kInf.
// `s` and `t` hold the envelope's parabola vertices and the first u where
// each is lowest, at stride `ss`. g and o are distinct buffers.
template <typename Idx>
__device__ void envelope_line(const int* __restrict__ g,
                              int* __restrict__ o, int64_t stride, int m,
                              Idx* s, Idx* t, int ss) {
  int q = -1;  // index of the last parabola of the envelope
  int gu = g[0];
  for (int u = 0; u < m; ++u) {
    const int gcur = gu;
    if (u + 1 < m) gu = g[(u + 1) * stride];  // one load ahead
    if (gcur == kInf) continue;
    // drop the parabolas that u's lies below at the start of their segment
    while (q >= 0) {
      const int sq = s[q * ss], tq = t[q * ss];
      const int a = tq - sq, b = tq - u;
      if (a * a + g[sq * stride] > b * b + gcur) {
        --q;
      } else {
        break;
      }
    }
    if (q < 0) {
      q = 0;
      s[0] = static_cast<Idx>(u);
      t[0] = 0;
    } else {
      // first w where u's parabola is below s[q]'s: 1 + floor of their
      // crossing, whose numerator is >= 0 once the loop above has stopped
      const int sq = s[q * ss];
      const int w =
          1 + (u * u - sq * sq + gcur - g[sq * stride]) / (2 * (u - sq));
      if (w < m) {
        ++q;
        s[q * ss] = static_cast<Idx>(u);
        t[q * ss] = static_cast<Idx>(w);
      }
    }
  }
  if (q < 0) {
    for (int u = 0; u < m; ++u) o[u * stride] = kInf;
    return;
  }
  for (int u = m - 1; u >= 0; --u) {
    const int sq = s[q * ss];
    const int a = u - sq;
    o[u * stride] = a * a + g[sq * stride];
    if (u == t[q * ss]) --q;
  }
}

// Passes 2 and 3: `lines` = outer * inner lines of m values at stride
// `inner` (pass 2: inner = Z, m = W, outer = N * H; pass 3: inner = W * Z,
// m = H, outer = N). Thread = line; neighbouring threads take neighbouring
// inner offsets. Shared memory: 2 * m * blockDim.x Idx.
template <typename Idx>
__global__ void envelope_pass(const int* __restrict__ in,
                              int* __restrict__ out, int64_t lines,
                              int64_t inner, int m) {
  extern __shared__ unsigned char smem[];
  const int64_t line =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (line >= lines) return;
  const int64_t base = (line / inner) * inner * m + line % inner;
  Idx* s = reinterpret_cast<Idx*>(smem) + threadIdx.x;
  Idx* t = s + static_cast<int64_t>(m) * blockDim.x;
  envelope_line<Idx>(in + base, out + base, inner, m, s, t, blockDim.x);
}

template <typename Idx>
cudaError_t launch_envelope(const int* in, int* out, int64_t outer,
                            int64_t inner, int m, cudaStream_t stream) {
  const int64_t per_thread = 2 * static_cast<int64_t>(m) * sizeof(Idx);
  int threads = kLineThreads;
  while (threads > 1 && per_thread * threads > kMaxShared) threads /= 2;
  if (per_thread * threads > kMaxShared) return cudaErrorInvalidValue;
  const int64_t lines = outer * inner;
  const int64_t blocks = (lines + threads - 1) / threads;
  envelope_pass<Idx>
      <<<static_cast<unsigned>(blocks), threads,
         static_cast<size_t>(per_thread * threads), stream>>>(in, out, lines,
                                                               inner, m);
  return cudaGetLastError();
}

cudaError_t launch_envelope_any(const int* in, int* out, int64_t outer,
                                int64_t inner, int64_t m,
                                cudaStream_t stream) {
  if (m <= 256) {
    return launch_envelope<uint8_t>(in, out, outer, inner,
                                    static_cast<int>(m), stream);
  }
  return launch_envelope<uint16_t>(in, out, outer, inner, static_cast<int>(m),
                                   stream);
}

}  // namespace

// labels: (n, h, w, z) uint8, contiguous; classes: bit c set for label c in
// the region; tmp, out: (n, h, w, z) int32 on the same card. z <= 1024,
// h, w <= 10000 (squared distances stay inside int32). Returns the
// cudaError_t of the launches (0 = success).
extern "C" int pt_edt_sq(const void* labels, int64_t n, int64_t h, int64_t w,
                         int64_t z, unsigned classes, void* tmp, void* out,
                         void* stream) {
  if (n < 1 || h < 1 || w < 1 || z < 1 || z > kMaxScanLine || h > 10000 ||
      w > 10000) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* lab = static_cast<const uint8_t*>(labels);
  int* o = static_cast<int*>(out);
  int* tm = static_cast<int*>(tmp);

  const int threads = static_cast<int>((z + 31) / 32 * 32);
  border_scan_z<<<static_cast<unsigned>(n * h * w), threads,
                  2 * threads * sizeof(int), st>>>(
      lab, o, static_cast<int>(h), static_cast<int>(w), static_cast<int>(z),
      classes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_envelope_any(o, tm, n * h, z, w, st);  // along W
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_envelope_any(tm, o, n, w * z, h, st));
}
