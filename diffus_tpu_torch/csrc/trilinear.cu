// Exact trilinear volume sample (kernel K2), in two forms.
//
// Replaces the Pallas TPU kernel diffus_tpu/kernels/tile_select_pallas.py
// (_kernel, :46, launched by tile_select, :88-145), reached through
// sample_trilinear_tile_fused (diffus_tpu/ops/sampling.py:664-700).  On the
// TPU the corners come from XLA row gathers of a 128-lane tile table and
// the kernel selects and blends lanes; what it computes is the exact
// trilinear value of the volume at the point.  Here the 8 corners come
// straight from the contiguous (D, H, W) f32 volume: no tile table.
//
// - The ray form (trilinear_march_kernel, diffus_trilinear_march) marches the rays
//   itself: sample k of ray r of pose p is at
//   source[p] + (float(k) * step) * dir[p, r], the three IEEE roundings of
//   ray_points (arange * step, then * dir, then + source), so no (..., 3)
//   point tensor is written and read back.  The idx is written only when
//   the caller passes an idx buffer: the service and pose recovery read
//   the values alone, as XLA drops the unread idx in the reference.
// - The points form (trilinear_points_kernel, diffus_trilinear_sample) samples
//   arbitrary (n, 3) points.
//
// Both call trilinear_at, so they cannot drift apart.  Arithmetic,
// identical to the plain sample_trilinear (diffus_tpu_torch/ops/sampling.py,
// JAX ops/sampling.py:109-152): clamp each component to [0, dim-1], floor,
// i1 = min(i0 + 1, dim - 1), blend z, then y, then x.  Built with
// --fmad=false, so each a*b + c rounds twice like the plain path's separate
// PyTorch ops and the values agree bit for bit.  idx = round-half-even
// (rintf; roundf rounds half away from zero), clamped per axis.  A NaN
// component gives a NaN value and index 0 on that axis, like the plain
// sampler.  Flat offsets are 64-bit.  Texture filtering is not used: its
// fixed-point fractions are far coarser than f32.
//
// The bound (chip_smoke.py's rule: each input read once, each output
// written once).  At the service's 32 poses x 256 rays x 512 samples the
// ray form writes 4 B a point (16 B with the idx) and reads the volume's
// distinct 32-byte sectors that the corners touch (58 436 on the 256^3
// phantom, 1.87 MB) and 6 floats a ray: 18.7 MB, 5.6 us at 3.35 TB/s
// values only, 69.0 MB, 20.6 us with the idx.  The first design of K2
// also read the 12-byte point triples and always wrote the idx: 28 B a
// point, 119 MB, 35.6 us, of which it reached 39%.
//
// What held the first design back: the streamed bytes above, and the corner
// loads.  One thread a sample, 8 scalar 4-byte loads each; a warp is 32
// samples of one ray, whose corners differ in x and y (the strided axes)
// and share z, so each load instruction touches up to 32 lines.  The
// working set (1.87 MB) lives in L1/L2: the distinct lines a warp's load
// instruction touches set the pace, not HBM.  What the design does, each
// item chosen by timing the variants at that size (values only, device
// time per launch; NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// - the points come from 6 floats a ray, and the idx only on request;
// - paired z loads: the corners z0 and z1 of an (x, y) column sit in the
//   aligned 16-byte quad that holds z0 unless z0 % 4 == 3, so one float4
//   load replaces two scalar ones (scalar loads remain for z0 % 4 == 3,
//   the clamped border, and rows not 16-byte aligned): 85.0 -> 61.5 us
//   with the first design's mapping;
// - a warp is a patch of adjacent rays x consecutive samples (4 x 8 as
//   shipped): near the apex neighbouring rays share corner columns, so a
//   load instruction touches fewer lines than 32 samples of one ray do:
//   61.5 -> 50.4 us (8 x 4 58.8, 16 x 2 66.9, 32 x 1 89.1 us);
// - one sample a thread: 4 consecutive samples a thread with 16-byte
//   stores took 71-72 us (the threads of a warp then sample 4 apart, and
//   each load instruction touches more lines), so stores stay 4 bytes, a
//   warp's 4 x 8 patch writing 4 32-byte segments.
// Not tried: staging a tile's corner footprint in shared memory.

#include "trilinear_common.cuh"

namespace {

constexpr int kThreads = 256;

// Clamped in floats first, as the plain sampler does: NaN gives index 0.
__device__ __forceinline__ int round_clamp(float p, int dim) {
  return static_cast<int>(rintf(fminf(fmaxf(p, 0.0f), static_cast<float>(dim - 1))));
}

// The corners z0 and z1 of one (x, y) column.  With `quad` (rows 16-byte
// aligned), one aligned float4 load covers both when z1 = z0 + 1 and
// z0 % 4 != 3.
__device__ __forceinline__ float2 z_pair(const float* __restrict__ col, int z0, int z1,
                                         bool quad) {
  if (quad && z1 == z0 + 1 && (z0 & 3) != 3) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(col + (z0 & ~3)));
    const int lane = z0 & 3;
    return lane == 0 ? make_float2(q.x, q.y)
                     : (lane == 1 ? make_float2(q.y, q.z) : make_float2(q.z, q.w));
  }
  return make_float2(__ldg(col + z0), __ldg(col + z1));
}

// The exact trilinear value of the volume at (px, py, pz).
__device__ __forceinline__ float trilinear_at(const float* __restrict__ vol, float px,
                                              float py, float pz, int d, int h, int w,
                                              bool quad) {
  int x0, x1, y0, y1, z0, z1;
  float fx, fy, fz;
  corner_coords(px, d, x0, x1, fx);
  corner_coords(py, h, y0, y1, fy);
  corner_coords(pz, w, z0, z1, fz);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const float* plane0 = vol + x0 * hw;
  const float* plane1 = vol + x1 * hw;
  const int64_t by0 = static_cast<int64_t>(y0) * w, by1 = static_cast<int64_t>(y1) * w;
  const float2 c00z = z_pair(plane0 + by0, z0, z1, quad);
  const float2 c01z = z_pair(plane0 + by1, z0, z1, quad);
  const float2 c10z = z_pair(plane1 + by0, z0, z1, quad);
  const float2 c11z = z_pair(plane1 + by1, z0, z1, quad);
  const float gz = 1.0f - fz, gy = 1.0f - fy, gx = 1.0f - fx;
  const float c00 = c00z.x * gz + c00z.y * fz;
  const float c01 = c01z.x * gz + c01z.y * fz;
  const float c10 = c10z.x * gz + c10z.y * fz;
  const float c11 = c11z.x * gz + c11z.y * fz;
  const float c0 = c00 * gy + c01 * fy;
  const float c1 = c10 * gy + c11 * fy;
  return c0 * gx + c1 * fx;
}

// A block is kRays adjacent rays x kAlong consecutive samples of one pose,
// one sample a thread, threads across the rays first: a warp is a patch of
// 4 rays x 8 samples.  The flat block index runs over (pose, ray tile,
// sample tile), sample tile fastest.
constexpr int kRays = 4;
constexpr int kAlong = kThreads / kRays;

__global__ void __launch_bounds__(kThreads)
    trilinear_march_kernel(const float* __restrict__ vol, const float* __restrict__ src,
                           const float* __restrict__ dirs, int64_t dir_pose_stride,
                           float* __restrict__ out, int32_t* __restrict__ idx, int n_rays,
                           int n, float step, int d, int h, int w, bool quad) {
  const int64_t k_tiles = (n + kAlong - 1) / kAlong;
  const int64_t r_tiles = (n_rays + kRays - 1) / kRays;
  const int64_t b = blockIdx.x;
  const int k = static_cast<int>(b % k_tiles) * kAlong + static_cast<int>(threadIdx.x / kRays);
  const int r = static_cast<int>((b / k_tiles) % r_tiles) * kRays +
                static_cast<int>(threadIdx.x % kRays);
  const int64_t p = b / (k_tiles * r_tiles);
  if (r >= n_rays || k >= n) return;
  const float* s = src + 3 * p;
  const float* dv = dirs + p * dir_pose_stride + 3 * static_cast<int64_t>(r);
  const float3 pt = march_point(s, dv, k, step);
  const int64_t at = (p * n_rays + r) * n + k;
  out[at] = trilinear_at(vol, pt.x, pt.y, pt.z, d, h, w, quad);
  if (idx != nullptr) {
    idx[3 * at] = round_clamp(pt.x, d);
    idx[3 * at + 1] = round_clamp(pt.y, h);
    idx[3 * at + 2] = round_clamp(pt.z, w);
  }
}

// The points form: one point a thread.
__global__ void __launch_bounds__(kThreads)
    trilinear_points_kernel(const float* __restrict__ vol, const float* __restrict__ pts,
                            float* __restrict__ out, int32_t* __restrict__ idx, int64_t n,
                            int d, int h, int w, bool quad) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float px = __ldg(pts + 3 * i), py = __ldg(pts + 3 * i + 1), pz = __ldg(pts + 3 * i + 2);
  out[i] = trilinear_at(vol, px, py, pz, d, h, w, quad);
  idx[3 * i] = round_clamp(px, d);
  idx[3 * i + 1] = round_clamp(py, h);
  idx[3 * i + 2] = round_clamp(pz, w);
}

bool rows_aligned(const float* vol, int w) {
  return w % 4 == 0 && reinterpret_cast<uintptr_t>(vol) % 16 == 0;
}

}  // namespace

// vol: (d, h, w) f32 contiguous; pts: (n, 3) f32 contiguous; out: (n,) f32;
// idx: (n, 3) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int diffus_trilinear_sample(const float* vol, const float* pts, float* out,
                                       int32_t* idx, int64_t n, int d, int h, int w,
                                       void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  trilinear_points_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(vol, pts, out, idx, n, d, h,
                                                                 w, rows_aligned(vol, w));
  return static_cast<int>(cudaGetLastError());
}

// vol: (d, h, w) f32 contiguous; src: (p, 3) f32 contiguous; dirs: rays of
// 3 f32, ray r of pose q at dirs + q * dir_pose_stride + 3 r (stride 0: one
// fan for every pose); out: (p, n_rays, n) f32; idx: (p, n_rays, n, 3)
// int32, or null for no idx.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int diffus_trilinear_march(const float* vol, const float* src, const float* dirs,
                                      int64_t dir_pose_stride, float* out, int32_t* idx,
                                      int64_t p, int n_rays, int n, float step, int d, int h,
                                      int w, void* stream) {
  if (p == 0 || n_rays == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = p * ((n_rays + kRays - 1) / kRays) * ((n + kAlong - 1) / kAlong);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  trilinear_march_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      vol, src, dirs, dir_pose_stride, out, idx, n_rays, n, step, d, h, w,
      rows_aligned(vol, w));
  return static_cast<int>(cudaGetLastError());
}
