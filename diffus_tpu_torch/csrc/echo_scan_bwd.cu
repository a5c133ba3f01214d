// The echo scan's backward (kernel K1b): dr for the gradient of the attenuated
// echo trace, as a warp-cooperative chunked scan run forwards, then backwards.
//
// Replaces the VJP of the Pallas TPU kernel's custom_vjp,
// diffus_tpu/kernels/propagation_pallas.py (_bwd, :145-148), which runs
// jax.vjp through the XLA scan (_echo_jnp_from_r).  Its plain PyTorch twin,
// in this kernel's order, is echo_backward_plain
// (diffus_tpu_torch/kernels/propagation_cuda.py), whose docstring derives it:
// with P_i = inv_i M_i P_{i-1} the forward's renormalized carries and G_i the
// cotangent of P_i from echo i, the carries' cotangents run the reverse
// affine recurrence
//
//   A_N = G_N,   A_{i-1} = G_{i-1} + inv_i M_i^T A_i,
//
// and dr_{i-1} = inv_i <A_i, (dM_i/dr) P_{i-1}>.  (The path through inv_i
// adds nothing in exact arithmetic: every echo is homogeneous of degree 0 in
// a carry.)
//
// Precision: every step runs in double, from the f32 r and grad and the
// factors exp(-att j) of depth_attenuation (in double), and dr is rounded to
// f32 once.  Near a resonance (d ~ 0) the echo's derivatives amplify the
// carries' rounding: with f32 carries in this chunked order the gradient sat
// ~10x further from float64 autograd than f32 autograd through the plain scan
// does (rendered phantom reflections, 511 interfaces); in double it sits ~10x
// nearer.  The forward's f32 table of repeated multiplications is not used:
// it drifts from exp(-att j) by up to ~3e-5 relative at depth 511.
//
// Design, per ray, on the forward's layout (echo_scan.cu): one group of
// kLanes lanes per ray, lane l owning the contiguous chunk of interfaces
// [l C, (l+1) C), r (f32) and grad * att (double) staged through shared
// memory with coalesced loads.
//  - The carries are recomputed from r, not stored by the forward: the
//    forward then writes nothing for its backward, and ctx keeps r only.
//    Pass 1 and the __shfl_up_sync scan give each chunk's carry in, as the
//    forward's order does, in double.
//  - The replay from the carry keeps each step's carry in and inv in shared
//    memory (step-major, lane-minor: no bank conflicts) and folds the chunk
//    into the affine map Y -> T Y + h that takes the cotangent entering the
//    chunk's last step to the one leaving its first (2x2 matrices T, h).
//  - An inclusive suffix scan of the maps over the group's lanes with
//    __shfl_down_sync (log2(kLanes) rounds), shifted by one: each lane's Y.
//  - Each lane walks its chunk backwards from Y, writes dr into the slot its
//    r came from, and the warp stores the rows with coalesced stores.
//
// What bounds it on the card: bytes, r and grad read once and dr written
// once, 12 B an interface (12.6 MB at 8 x 256 rays x 511, 3.8 us at
// 3.35 TB/s); the VJP's ~70 operations an interface (the forward step and
// the reverse one) are 2.2 us at the 34 TFLOP/s of f64 at that size (this
// design does ~130: the chunk products, the replay with the map's fold, and
// the walk back).  Shared memory: per lane a row of r (4 B) and of grad *
// att (8 B) and 5 doubles a step (the carry in and inv), 32 x (12 (C + 1) +
// 40 C) B a warp (27 KB at N = 511 and 32 lanes; N up to ~5700 at 32
// lanes): one warp a block.
//
// Numerics: built with --fmad=false and IEEE division, every operation in the
// twin's order, in double as the twin, so kernel == twin bit for bit.  The
// max in the renormalization propagates NaN, as torch.maximum does.  The
// echo's cotangent follows
// autograd through nan_to_num(-(c/d)): zero where c/d is not finite, and the
// division's backward forms 0/0 = NaN at d' = 0 and NaN on a NaN carry, so a
// NaN interface or a d' = 0 echo makes its ray's whole dr NaN, as jax.grad
// through echo_pallas does.  The padding (r = 0, grad 0) adds no cotangent.

#include "echo_scan_common.cuh"

namespace {

using DMat = Mat<double>;

template <int kLanes>
__device__ __forceinline__ DMat shfl_down(const DMat& m, int delta) {
  return {__shfl_down_sync(kFullMask, m.a, delta, kLanes),
          __shfl_down_sync(kFullMask, m.b, delta, kLanes),
          __shfl_down_sync(kFullMask, m.c, delta, kLanes),
          __shfl_down_sync(kFullMask, m.d, delta, kLanes)};
}

// The echo's cotangent on the carry's (c, d): g the echo's gradient times its
// attenuation factor; zero on the padding (real false).
__device__ __forceinline__ void echo_cotangent(const DMat& p, double g, bool real, double& gc,
                                               double& gd) {
  if (!real) {
    gc = 0.0;
    gd = 0.0;
    return;
  }
  const double q = p.c / p.d;
  const double t = (isfinite(q) ? g : 0.0) / p.d;
  gc = -t;
  gd = t * q;
}

// r: (b, n) f32; grad: (b, n + 1) f32; att: (n + 1,) double; dr: (b, n) f32.
// One warp a block, 32 / kLanes rays a warp.  Shared: r's chunks (then
// dr's), lane i's at i * stride (f32), grad * att's chunks likewise (double),
// then per step i of a chunk the carry in and inv at [(5 i + f) * 32 + lane]
// (double).
template <bool kParity, int kLanes>
__global__ void __launch_bounds__(32)
echo_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ grad,
                     const double* __restrict__ att, float* __restrict__ dr, int n, int c,
                     int stride, int64_t b) {
  extern __shared__ double dsmem[];
  constexpr int kRays = 32 / kLanes;
  const int lane = threadIdx.x;
  const int l = lane % kLanes;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRays;
  double* const grads = dsmem;
  double* const saved = dsmem + 32 * stride + lane;
  float* const rows = reinterpret_cast<float*>(dsmem + 32 * stride + 5 * 32 * c);
  float* const chunk = rows + lane * stride;
  const double* const gchunk = grads + lane * stride;
  const int j0 = l * c;  // this chunk's first interface in its ray

  for (int g = 0; g < kRays; ++g) {
    const bool ok = first + g < b;
    const float* src = r + (first + g) * n;
    const float* gsrc = grad + (first + g) * (n + 1);
    const int at = g * kLanes * stride;
    ChunkPos pos(lane, c);
    for (int j = lane; j < kLanes * c; j += 32, pos.advance32()) {
      const bool in = ok && j < n;
      rows[at + pos.at(stride)] = in ? src[j] : 0.0f;
      grads[at + pos.at(stride)] = in ? static_cast<double>(gsrc[j + 1]) * att[j + 1] : 0.0;
    }
  }
  __syncwarp();

  // pass 1 and the scan over the group's chunks: the carry in
  DMat p = carry_in<kParity, kLanes, double>(chunk, c, l);

  // replay: keep each step's carry in and inv; fold the chunk into (T, h)
  DMat t = {1.0, 0.0, 0.0, 1.0}, h = {0.0, 0.0, 0.0, 0.0};
  for (int i = 0; i < c; ++i) {
    double* sv = saved + 5 * 32 * i;
    sv[0] = p.a;
    sv[32] = p.b;
    sv[64] = p.c;
    sv[96] = p.d;
    const double x = chunk[i];
    const double k = kParity ? 1.0 - 2.0 * x * x : 1.0;
    const double m10 = kParity ? -x : x;
    double inv;
    p = step<kParity>(p, x, inv);
    sv[128] = inv;
    t = {(t.a * k + t.b * x) * inv, (t.a * m10 + t.b) * inv, (t.c * k + t.d * x) * inv,
         (t.c * m10 + t.d) * inv};
    double gc, gd;
    echo_cotangent(p, gchunk[i], j0 + i < n, gc, gd);
    h = {h.a + t.b * gc, h.b + t.b * gd, h.c + t.d * gc, h.d + t.d * gd};
  }

  // inclusive suffix scan of the maps over the group's lanes, shifted by one
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const DMat to = shfl_down<kLanes>(t, o), ho = shfl_down<kLanes>(h, o);
    if (l + o < kLanes) {
      h = {t.a * ho.a + t.b * ho.c + h.a, t.a * ho.b + t.b * ho.d + h.b,
           t.c * ho.a + t.d * ho.c + h.c, t.c * ho.b + t.d * ho.d + h.d};
      t = {t.a * to.a + t.b * to.c, t.a * to.b + t.b * to.d, t.c * to.a + t.d * to.c,
           t.c * to.b + t.d * to.d};
    }
  }
  DMat bt = shfl_down<kLanes>(h, 1);
  if (l == kLanes - 1) bt = {0.0, 0.0, 0.0, 0.0};

  // walk the chunk backwards; p is the carry after step i
  for (int i = c - 1; i >= 0; --i) {
    const double* sv = saved + 5 * 32 * i;
    const DMat q0 = {sv[0], sv[32], sv[64], sv[96]};  // the carry before step i
    const double inv = sv[128];
    const double x = chunk[i];
    double gc, gd;
    echo_cotangent(p, gchunk[i], j0 + i < n, gc, gd);
    const DMat a = {bt.a, bt.b, bt.c + gc, bt.d + gd};
    double k, m10, dr_i;
    if (kParity) {
      const double m4 = -4.0 * x;
      k = 1.0 - 2.0 * x * x;
      m10 = -x;
      dr_i = a.a * (m4 * q0.a + q0.c) + a.b * (m4 * q0.b + q0.d) + a.c * (-q0.a) +
             a.d * (-q0.b);
    } else {
      k = 1.0;
      m10 = x;
      dr_i = a.a * q0.c + a.b * q0.d + a.c * q0.a + a.d * q0.b;
    }
    chunk[i] = __double2float_rn(dr_i * inv);  // the slot of r_j now holds dr_j
    bt = {(k * a.a + m10 * a.c) * inv, (k * a.b + m10 * a.d) * inv, (x * a.a + a.c) * inv,
          (x * a.b + a.d) * inv};
    p = q0;
  }

  __syncwarp();
  for (int g = 0; g < kRays && first + g < b; ++g) {
    float* dst = dr + (first + g) * n;
    const float* src = rows + g * kLanes * stride;
    ChunkPos pos(lane, c);
    for (int j = lane; j < n; j += 32, pos.advance32()) dst[j] = src[pos.at(stride)];
  }
}

template <bool kParity, int kLanes>
cudaError_t launch(const float* r, const float* grad, const double* att, float* dr, int n,
                   int64_t b, cudaStream_t stream) {
  const int c = n > 0 ? (n + kLanes - 1) / kLanes : 1;
  const int stride = c | 1;  // odd: lanes reading word i of their chunks hit distinct banks
  const size_t smem = 32 * (12 * static_cast<size_t>(stride) + 40 * static_cast<size_t>(c));
  auto kernel = echo_scan_bwd_kernel<kParity, kLanes>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch's check must not see it
      return e;
    }
  }
  constexpr int64_t kRaysPerBlock = 32 / kLanes;
  const int64_t blocks = (b + kRaysPerBlock - 1) / kRaysPerBlock;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), 32, smem, stream>>>(r, grad, att, dr, n, c, stride, b);
  return cudaGetLastError();
}

template <bool kParity>
cudaError_t launch_lanes(int lanes, const float* r, const float* grad, const double* att,
                         float* dr, int n, int64_t b, cudaStream_t stream) {
  switch (lanes) {
    case 8:
      return launch<kParity, 8>(r, grad, att, dr, n, b, stream);
    case 16:
      return launch<kParity, 16>(r, grad, att, dr, n, b, stream);
    case 32:
      return launch<kParity, 32>(r, grad, att, dr, n, b, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r: (b, n) f32 ray-major; grad: (b, n + 1) f32, the gradient of the echo
// trace; att: (n + 1,) double, exp(-att j); dr:
// (b, n) f32.  mode 0 = parity, 1 = symmetric; lanes 8, 16 or 32 per ray.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for
// a mode or a lane count it is not built for, or a row too long for shared
// memory), as diffus_echo_scan does.
extern "C" int diffus_echo_scan_bwd(const float* r, const float* grad, const double* att,
                                    float* dr, int n, int64_t b, int mode, int lanes,
                                    void* stream) {
  if (b == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return static_cast<int>(launch_lanes<true>(lanes, r, grad, att, dr, n, b, s));
  if (mode == 1) return static_cast<int>(launch_lanes<false>(lanes, r, grad, att, dr, n, b, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
