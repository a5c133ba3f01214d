// Fused echo scan + depth attenuation along rays (kernel K1).
//
// Replaces the Pallas TPU kernel diffus_tpu/kernels/propagation_pallas.py
// (_kernel, :45, launched by _echo_pallas_raw, :87-109).  Per ray it runs
// the sequential 2x2 transfer-matrix recurrence over the N interfaces:
//
//   a' = k pa + r pc        parity:    k = 1 - 2 r^2, rho = r
//   b' = k pb + r pd        symmetric: k = 1,         rho = -r
//   c' = pc - rho pa
//   d' = pd - rho pb
//
// renormalizes the four entries by their max-abs (floored at 1e-30) and
// writes echo[i+1] = nan_to_num(-c'/d') * att_{i+1}, with att multiplied
// by decay = f32(exp(-att)) at each step; echo[0] = 0.
//
// What bounds it on the card: the latency of the sequential loop.  Each
// step is ~20 dependent flops on the carry, and a ray has N = 511 steps.
// The design: one thread per ray, the carry and att_i in registers, the
// loop over N inside the thread.  r is read depth-major (N, B), so the 32
// lanes of a warp load 32 neighbouring rays of step i in one coalesced
// 128-byte transaction; loads do not depend on the carry, so the unrolled
// loop keeps several in flight.  Its limit is occupancy: one frame is
// 256 rays = 2 blocks of 128 on a card with 132 SMs, a 32-pose batch 64.
//
// Numerics follow the Pallas kernel and the plain PyTorch path:
//  - max() propagates NaN like jnp.maximum / torch.maximum (fmaxf would
//    drop it and let a partly-NaN carry renormalize);
//  - nan_to_num(nan=0) also maps +-inf to +-FLT_MAX (d' = 0 gives +-inf);
//  - 1/max(s, 1e-30) once, then four multiplies, as the Pallas kernel.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

template <bool kParity>
__global__ void echo_scan_kernel(const float* __restrict__ r, float* __restrict__ out,
                                 int n, int64_t b, float decay) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= b) return;
  float pa = 1.0f, pb = 0.0f, pc = 0.0f, pd = 1.0f, att = 1.0f;
  out[j] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float ri = r[static_cast<int64_t>(i) * b + j];
    const float k = kParity ? 1.0f - 2.0f * ri * ri : 1.0f;
    const float rho = kParity ? ri : -ri;
    float a2 = k * pa + ri * pc;
    float b2 = k * pb + ri * pd;
    float c2 = pc - rho * pa;
    float d2 = pd - rho * pb;
    const float s = max_nan(max_nan(fabsf(a2), fabsf(b2)), max_nan(fabsf(c2), fabsf(d2)));
    const float inv = 1.0f / max_nan(s, 1e-30f);
    pa = a2 * inv;
    pb = b2 * inv;
    pc = c2 * inv;
    pd = d2 * inv;
    att = att * decay;
    out[static_cast<int64_t>(i + 1) * b + j] = nan_to_num(-(pc / pd)) * att;
  }
}

}  // namespace

// r: (n, b) f32 depth-major; out: (n + 1, b) f32.  mode 0 = parity,
// 1 = symmetric.  Launches on `stream`; returns cudaGetLastError().
extern "C" int diffus_echo_scan(const float* r, float* out, int n, int64_t b, int mode,
                                float decay, void* stream) {
  if (b == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 128;
  const dim3 grid(static_cast<unsigned>((b + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    echo_scan_kernel<true><<<grid, kThreads, 0, s>>>(r, out, n, b, decay);
  } else {
    echo_scan_kernel<false><<<grid, kThreads, 0, s>>>(r, out, n, b, decay);
  }
  return static_cast<int>(cudaGetLastError());
}
