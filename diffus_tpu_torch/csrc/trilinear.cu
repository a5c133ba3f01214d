// Exact trilinear volume sample at arbitrary points (kernel K2).
//
// Replaces the Pallas TPU kernel diffus_tpu/kernels/tile_select_pallas.py
// (_kernel, :46, launched by tile_select, :88-145), reached through
// sample_trilinear_tile_fused (diffus_tpu/ops/sampling.py:664-700).  On the
// TPU the corners come from XLA row gathers of a 128-lane tile table and
// the kernel selects and blends lanes; what it computes is the exact
// trilinear value of the volume at the point.  Here one thread per sample
// reads the 8 corners straight from the contiguous (D, H, W) f32 volume:
// no tile table.
//
// Arithmetic, identical to the plain sample_trilinear
// (diffus_tpu_torch/ops/sampling.py, JAX ops/sampling.py:109-152):
// clamp each component to [0, dim-1], floor, i1 = min(i0 + 1, dim - 1),
// blend z, then y, then x.  Built with --fmad=false, so each a*b + c rounds
// twice like the plain path's separate PyTorch ops and the values agree
// bit for bit.  idx = round-half-even(point) (rintf; roundf rounds half
// away from zero), clamped per axis.  Flat offsets are 64-bit.  Texture
// filtering is not used: its fixed-point fractions are far coarser than f32.
//
// What bounds it on the card: random 4-byte loads, 8 per sample, plus 28
// streamed bytes a sample (the point in; the value and the int32 idx out).
// Neighbouring rays of a fan visit neighbouring voxels, and a 256^3 f32
// volume (67 MB) is about the size of L2 (50 MB), so many corner loads
// should hit cache.  The design does nothing cleverer yet: __ldg loads
// through the read-only path, one sample per thread.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ void corner_coords(float p, int dim, int& i0, int& i1, float& f) {
  const float c = fminf(fmaxf(p, 0.0f), static_cast<float>(dim - 1));
  const float fl = floorf(c);
  f = c - fl;
  i0 = static_cast<int>(fl);
  i1 = min(i0 + 1, dim - 1);
}

__device__ __forceinline__ int round_clamp(float p, int dim) {
  const int i = static_cast<int>(rintf(p));
  return min(max(i, 0), dim - 1);
}

__global__ void trilinear_kernel(const float* __restrict__ vol, const float* __restrict__ pts,
                                 float* __restrict__ out, int32_t* __restrict__ idx,
                                 int64_t n, int d, int h, int w) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const float px = pts[3 * t], py = pts[3 * t + 1], pz = pts[3 * t + 2];
  int x0, x1, y0, y1, z0, z1;
  float fx, fy, fz;
  corner_coords(px, d, x0, x1, fx);
  corner_coords(py, h, y0, y1, fy);
  corner_coords(pz, w, z0, z1, fz);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t bx0 = x0 * hw, bx1 = x1 * hw;
  const int64_t by0 = static_cast<int64_t>(y0) * w, by1 = static_cast<int64_t>(y1) * w;
  const float c000 = __ldg(vol + bx0 + by0 + z0);
  const float c001 = __ldg(vol + bx0 + by0 + z1);
  const float c010 = __ldg(vol + bx0 + by1 + z0);
  const float c011 = __ldg(vol + bx0 + by1 + z1);
  const float c100 = __ldg(vol + bx1 + by0 + z0);
  const float c101 = __ldg(vol + bx1 + by0 + z1);
  const float c110 = __ldg(vol + bx1 + by1 + z0);
  const float c111 = __ldg(vol + bx1 + by1 + z1);
  const float gz = 1.0f - fz, gy = 1.0f - fy, gx = 1.0f - fx;
  const float c00 = c000 * gz + c001 * fz;
  const float c01 = c010 * gz + c011 * fz;
  const float c10 = c100 * gz + c101 * fz;
  const float c11 = c110 * gz + c111 * fz;
  const float c0 = c00 * gy + c01 * fy;
  const float c1 = c10 * gy + c11 * fy;
  out[t] = c0 * gx + c1 * fx;
  idx[3 * t] = round_clamp(px, d);
  idx[3 * t + 1] = round_clamp(py, h);
  idx[3 * t + 2] = round_clamp(pz, w);
}

}  // namespace

// vol: (d, h, w) f32 contiguous; pts: (n, 3) f32 contiguous; out: (n,) f32;
// idx: (n, 3) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int diffus_trilinear_sample(const float* vol, const float* pts, float* out,
                                       int32_t* idx, int64_t n, int d, int h, int w,
                                       void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  trilinear_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vol, pts, out, idx, n, d, h, w);
  return static_cast<int>(cudaGetLastError());
}
