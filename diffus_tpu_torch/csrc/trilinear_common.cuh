// Device helpers shared by the trilinear sampler (trilinear.cu, kernel K2)
// and its backward (trilinear_bwd.cu, kernel K2b), so that the backward sees
// the forward's points, corners and fractions.

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

}  // namespace
