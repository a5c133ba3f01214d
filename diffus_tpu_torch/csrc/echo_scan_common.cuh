// Device helpers of the echo scan (echo_scan.cu, kernel K1, in float): one
// step, one combine and one carry-in scan.  Its backward (echo_scan_bwd.cu,
// kernel K1b, in double) shares the matrix type and the warp shuffle only: it
// renormalizes by powers of two, in its own order.  Numerics: see
// echo_scan.cu.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// The larger of a and b, NaN if either is NaN, as jnp.maximum and
// torch.maximum; fmaxf would drop the NaN.  One PTX max.NaN (sm_80 and
// later).
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

// A 2x2 matrix [[a, b], [c, d]].
template <typename T>
struct Mat {
  T a, b, c, d;
};

// (a, b, c, d) over its max-abs entry (floored at 1e-30); inv is the factor.
template <typename T>
__device__ __forceinline__ Mat<T> renormalized(T a, T b, T c, T d, T& inv) {
  const T s = max_nan(max_nan(fabs(a), fabs(b)), max_nan(fabs(c), fabs(d)));
  inv = T(1) / max_nan(s, T(1e-30));
  return {a * inv, b * inv, c * inv, d * inv};
}

// The later product q left-multiplies the earlier p (ops/propagation.py _combine).
template <typename T>
__device__ __forceinline__ Mat<T> combine(const Mat<T>& p, const Mat<T>& q, T& inv) {
  return renormalized(q.a * p.a + q.b * p.c, q.a * p.b + q.b * p.d,
                      q.c * p.a + q.d * p.c, q.c * p.b + q.d * p.d, inv);
}

// One interface [[k, r], [-rho, 1]] left-multiplies the carry p; without
// FMAs, -rho pa + 1 pc rounds as the Pallas kernel's pc - rho pa.  inv is
// the renormalization's factor.
template <bool kParity, typename T>
__device__ __forceinline__ Mat<T> step(const Mat<T>& p, T r, T& inv) {
  const T k = kParity ? T(1) - T(2) * r * r : T(1);
  return combine(p, Mat<T>{k, r, kParity ? -r : r, T(1)}, inv);
}

template <int kLanes, typename T>
__device__ __forceinline__ Mat<T> shfl_up(const Mat<T>& m, int delta) {
  return {__shfl_up_sync(kFullMask, m.a, delta, kLanes),
          __shfl_up_sync(kFullMask, m.b, delta, kLanes),
          __shfl_up_sync(kFullMask, m.c, delta, kLanes),
          __shfl_up_sync(kFullMask, m.d, delta, kLanes)};
}

// Each chunk's carry in, for lane l of a group of kLanes lanes whose chunk
// of c interfaces is `chunk`: pass 1 forms the chunk's product from the
// identity, then an inclusive scan over the group's chunks with
// __shfl_up_sync (log2(kLanes) rounds, later left-multiplying earlier,
// renormalized after each combine with the NaN-propagating max) is shifted
// by one: lane 0's carry is the identity.
template <bool kParity, int kLanes, typename T>
__device__ __forceinline__ Mat<T> carry_in(const float* chunk, int c, int l) {
  T inv;
  Mat<T> q = {T(1), T(0), T(0), T(1)};
  for (int i = 0; i < c; ++i) q = step<kParity>(q, T(chunk[i]), inv);
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const Mat<T> p = shfl_up<kLanes>(q, o);
    if (l >= o) q = combine(p, q, inv);
  }
  Mat<T> carry = shfl_up<kLanes>(q, 1);
  if (l == 0) carry = {T(1), T(0), T(0), T(1)};
  return carry;
}

// The position (j / c, j % c) of interface j in the chunks, kept as j steps
// by 32 with no division per step.
struct ChunkPos {
  int jc, ji;
  const int c, dq, dm;
  __device__ ChunkPos(int j, int c_) : jc(j / c_), ji(j % c_), c(c_), dq(32 / c_), dm(32 % c_) {}
  __device__ int at(int stride) const { return jc * stride + ji; }
  __device__ void advance32() {
    jc += dq;
    ji += dm;
    if (ji >= c) {
      ji -= c;
      ++jc;
    }
  }
};

}  // namespace
