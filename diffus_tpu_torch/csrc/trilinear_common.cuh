// Device helpers shared by the trilinear sampler (trilinear.cu, kernel K2),
// its backward (trilinear_bwd.cu, kernel K2b) and the nearest sampler
// (nearest.cu, kernel K5), so that the backward sees the forward's points,
// corners and fractions, and both samplers round their idx alike.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

// fmaxf/fminf drop a NaN, so a NaN component reads voxel 0 as its corners;
// its fraction stays NaN, and so does the sample, as in the plain sampler.
__device__ __forceinline__ void corner_coords(float p, int dim, int& i0, int& i1, float& f) {
  const float c = fminf(fmaxf(p, 0.0f), static_cast<float>(dim - 1));
  const float fl = floorf(c);
  f = isnan(p) ? p : c - fl;
  i0 = static_cast<int>(fl);
  i1 = min(i0 + 1, dim - 1);
}

// Sample k of a ray from `s` along `dv`: ray_points' three IEEE roundings
// (arange * step, then * dir, then + source).
__device__ __forceinline__ float3 march_point(const float* __restrict__ s,
                                              const float* __restrict__ dv, int k, float step) {
  const float t = static_cast<float>(k) * step;
  return make_float3(__ldg(s) + t * __ldg(dv), __ldg(s + 1) + t * __ldg(dv + 1),
                     __ldg(s + 2) + t * __ldg(dv + 2));
}

// One coordinate of the same, for sources of type S and directions of type
// D (K5 takes float and double): k * step and its product with the
// direction in D, their sum with the source in the wider of the two types,
// as PyTorch promotes them in ray_points.
template <typename S, typename D>
__device__ __forceinline__ decltype(S() + D()) march_coord(const S* __restrict__ s,
                                                           const D* __restrict__ dv, int k,
                                                           D step) {
  using P = decltype(S() + D());
  return static_cast<P>(__ldg(s)) + static_cast<P>((static_cast<D>(k) * step) * __ldg(dv));
}

// The nearest index of a coordinate on an axis of `dim` voxels: clamped in
// floats to [0, dim - 1] first, as the plain sampler does (fmaxf/fminf send
// NaN to 0 and +-inf to the bounds), then rounded half to even (rintf;
// roundf rounds half away from zero).
__device__ __forceinline__ int round_clamp(float p, int dim) {
  return static_cast<int>(rintf(fminf(fmaxf(p, 0.0f), static_cast<float>(dim - 1))));
}

__device__ __forceinline__ int round_clamp(double p, int dim) {
  return static_cast<int>(rint(fmin(fmax(p, 0.0), static_cast<double>(dim - 1))));
}

}  // namespace
