// Fused echo scan + depth attenuation along rays (kernel K1), as a
// warp-cooperative chunked scan over ray-major rows.
//
// Replaces the Pallas TPU kernel diffus_tpu/kernels/propagation_pallas.py
// (_kernel, :45, launched by _echo_pallas_raw, :87-109).  Per ray it computes
// the sequential 2x2 transfer-matrix recurrence over the N interfaces:
//
//   a' = k pa + r pc        parity:    k = 1 - 2 r^2, rho = r
//   b' = k pb + r pd        symmetric: k = 1,         rho = -r
//   c' = pc - rho pa
//   d' = pd - rho pb
//
// renormalizes the four entries by their max-abs (floored at 1e-30) and
// writes echo[i+1] = nan_to_num(-c'/d') * att_{i+1}; echo[0] = 0.
//
// What bounds it on the card: bytes.  4 B in and 4 B out per interface,
// 33.5 MB at 8192 x 511, is 10 us at 3.35 TB/s; its ~35 flops a step are
// ~2 us at 67 TFLOP/s.  A ray's steps depend on each other, so the limit
// of a one-thread-per-ray loop is latency: 511 dependent steps of ~20
// flops, a reciprocal and a division each, on only B threads (8192 rays =
// 64 blocks of 128 on 132 SMs).  The design spends ~2x the flops to cut
// the dependent chain ~16x:
//
//  - One group of L lanes (L = 8, 16 or 32, a template parameter) per ray;
//    lane l owns the contiguous chunk of interfaces [l C, (l+1) C), with
//    C = ceil(N / L), padded with r = 0 (the identity step in both modes).
//  - Pass 1: each lane forms its chunk's product Q from the identity, with
//    the per-step left-multiply and renormalization above.
//  - Scan: an exclusive scan of the Q over the group's lanes with
//    __shfl_up_sync, log2(L) rounds, later left-multiplying earlier and
//    renormalizing after each combine with the NaN-propagating max (so a
//    NaN chunk poisons every later carry).
//  - Pass 2: each lane replays its chunk from its carry and writes its
//    echoes.  Lane 0 replays from the identity, so its echoes are the
//    sequential loop's bit for bit; lane 1's carry is lane 0's product
//    exactly; lanes >= 2 round in another order.  At N = 511 and L = 32,
//    C = 16: a 32-pose batch is 8192 warps in one wave on 132 SMs.
//
// Layout: r is read ray-major (B, N) and written (B, N+1), the renderer's
// layout, so the wrapper transposes nothing.  A row of N = 511 floats is
// 2044 B and not 16-byte aligned, so TMA and cp.async.bulk (16-byte
// aligned sources) do not apply.  Each warp stages its rows through shared
// memory with coalesced 4-byte loads (the 32 lanes read 128 contiguous
// bytes), chunk l at offset l * stride with an odd stride (C or C + 1) so
// that lane l reading word l * stride + i hits bank (l * stride + i) mod 32,
// a different bank per lane.  Pass 2 writes each echo into the slot its r
// came from, and the warp stores the (N+1)-float row with coalesced 4-byte
// stores, times the attenuation factor.  Reading each lane's chunk straight
// from device memory instead (every warp load touching 32 rows' sectors,
// served from L1) took 2.6x as long at 8192 x 511 on the H100 (PERF.md).
//
// Attenuation: att_{j} comes from a device table of the N+1 factors that
// the wrapper builds once per (N, att) by f32 repeated multiplication by
// f32(exp(-att)), the Pallas kernel's order, so each factor is the one the
// sequential loop forms (a lane cannot repeat the multiplication from 0).
//
// Numerics follow the Pallas kernel and the plain PyTorch path:
//  - max() propagates NaN like jnp.maximum / torch.maximum, in one
//    max.NaN instruction (fmaxf would drop it and let a partly-NaN carry
//    renormalize);
//  - nan_to_num(nan=0) also maps +-inf to +-FLT_MAX (d' = 0 gives +-inf);
//  - 1/max(s, 1e-30) once, then four multiplies, as the Pallas kernel;
//  - built with --fmad=false and IEEE division, so every operation rounds
//    like the plain PyTorch twin echo_chunked_plain
//    (diffus_tpu_torch/kernels/propagation_cuda.py), which follows this
//    order step for step.

#include "echo_scan_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 2;
constexpr int kThreads = 32 * kWarpsPerBlock;

// r: (b, n) f32; att: (n + 1,) f32; out: (b, n + 1) f32.  A warp holds 32 / kLanes
// rays; its shared rows are 32 chunks of `stride` floats, lane i's at i * stride.
template <bool kParity, int kLanes>
__global__ void __launch_bounds__(kThreads)
echo_scan_kernel(const float* __restrict__ r, const float* __restrict__ att,
                 float* __restrict__ out, int n, int c, int stride, int64_t b) {
  extern __shared__ float smem[];
  constexpr int kRays = 32 / kLanes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = lane % kLanes;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp) * kRays;
  float* const rows = smem + warp * 32 * stride;
  float* const chunk = rows + lane * stride;

  for (int g = 0; g < kRays; ++g) {
    const bool ok = first + g < b;
    const float* src = r + (first + g) * n;
    float* dst = rows + g * kLanes * stride;
    ChunkPos pos(lane, c);
    for (int j = lane; j < kLanes * c; j += 32, pos.advance32())
      dst[pos.at(stride)] = (ok && j < n) ? src[j] : 0.0f;
  }
  __syncwarp();

  // pass 1 and the scan over the group's chunks: the carry in
  Mat<float> carry = carry_in<kParity, kLanes, float>(chunk, c, l);

  // pass 2: replay the chunk from the carry
  float inv;
  for (int i = 0; i < c; ++i) {
    carry = step<kParity>(carry, chunk[i], inv);
    chunk[i] = nan_to_num(-(carry.c / carry.d));  // the slot of r_j now holds echo j + 1
  }

  __syncwarp();
  for (int g = 0; g < kRays && first + g < b; ++g) {
    float* dst = out + (first + g) * (n + 1);
    const float* src = rows + g * kLanes * stride;
    if (lane == 0) dst[0] = 0.0f;
    ChunkPos pos(lane, c);
    for (int j = lane; j < n; j += 32, pos.advance32()) dst[j + 1] = src[pos.at(stride)] * att[j + 1];
  }
}

template <bool kParity, int kLanes>
cudaError_t launch(const float* r, const float* att, float* out, int n, int64_t b,
                   cudaStream_t stream) {
  const int c = n > 0 ? (n + kLanes - 1) / kLanes : 1;
  const int stride = c | 1;  // odd: lanes reading word i of their chunks hit 32 banks
  const size_t smem = sizeof(float) * 32 * kWarpsPerBlock * stride;
  auto kernel = echo_scan_kernel<kParity, kLanes>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch's check must not see it
      return e;
    }
  }
  constexpr int64_t kRaysPerBlock = kWarpsPerBlock * (32 / kLanes);
  const int64_t blocks = (b + kRaysPerBlock - 1) / kRaysPerBlock;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(r, att, out, n, c, stride,
                                                                     b);
  return cudaGetLastError();
}

template <bool kParity>
cudaError_t launch_lanes(int lanes, const float* r, const float* att, float* out, int n,
                         int64_t b, cudaStream_t stream) {
  switch (lanes) {
    case 8:
      return launch<kParity, 8>(r, att, out, n, b, stream);
    case 16:
      return launch<kParity, 16>(r, att, out, n, b, stream);
    case 32:
      return launch<kParity, 32>(r, att, out, n, b, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r: (b, n) f32 ray-major; att: (n + 1,) f32 attenuation factors; out:
// (b, n + 1) f32.  mode 0 = parity, 1 = symmetric; lanes 8, 16 or 32 per
// ray.  Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for a mode or a lane count it is not built for, or a row too long for
// shared memory).
extern "C" int diffus_echo_scan(const float* r, const float* att, float* out, int n, int64_t b,
                                int mode, int lanes, void* stream) {
  if (b == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return static_cast<int>(launch_lanes<true>(lanes, r, att, out, n, b, s));
  if (mode == 1) return static_cast<int>(launch_lanes<false>(lanes, r, att, out, n, b, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
