// The ray-marching trilinear sampler's backward (kernel K2b): the gradients
// of the volume, the rays' sources and their directions for the gradient of
// the sampled values, each only when asked.
//
// Replaces the VJP of the Pallas TPU kernel's custom_vjp,
// diffus_tpu/kernels/tile_select_pallas.py (_bwd, :153-160), which runs
// jax.vjp through the XLA blend (_select_jnp): the tile rows' gradient (to
// the volume) and the fractions' (to the points).  Here, as K2's ray form
// (trilinear.cu) does forwards, it starts from the ray form's own inputs: it
// recomputes each sample's point (ray_points' roundings), corners and
// fractions (trilinear_common.cuh) and reads no idx.  Its plain PyTorch twin,
// in this kernel's order, is march_trilinear_backward_plain
// (diffus_tpu_torch/kernels/trilinear_cuda.py).
//
// Per sample, with g the value's gradient and (fx, fy, fz) the fractions
// (gx = 1 - fx, ...): the blends' adjoints dc0 = g gx, dc1 = g fx,
// dc00 = dc0 gy, dc01 = dc0 fy, dc10 = dc1 gy, dc11 = dc1 fy; corner (x, y,
// z) receives dcXY gz or dcXY fz; and
//   dfx = g (c1 - c0),  dfy = dc0 (c01 - c00) + dc1 (c11 - c10),
//   dfz = dc00 (v001 - v000) + dc01 (v011 - v010) + dc10 (v101 - v100)
//         + dc11 (v111 - v110),
// with the forward's blends c.  The clamp to [0, dim - 1] passes a
// fraction's gradient to the point inside, half of it at p = dim - 1 (the
// tie of torch.minimum) and none outside or for a NaN component (as
// torch.clamp(min=0) and torch.minimum do in the plain sampler).  A point's
// gradient goes to the source as is and to the direction times k * step.
//
// The volume gradient is a scatter: many samples touch one voxel.  It must
// be deterministic (the smoke trains a chaotic configuration under
// torch.use_deterministic_algorithms, which does not cover a custom kernel),
// so it sums in integer fixed point, where addition is associative and the
// order of the atomics cannot change the result:
//  - scale 2^e, e = 61 - ceil(log2(n_samples)) - E, where max |g| over the
//    finite g lies in [2^(E-1), 2^E) (frexpf): a sample's corner weights sum
//    to 1, so every voxel's sum stays below n_samples * 2^E and its scaled
//    sum below 2^62, inside int64;
//  - each finite corner contribution c adds round-half-even(c * 2^e), in
//    double (exact), with a 64-bit integer atomicAdd; a non-finite one sets
//    the voxel's bit in a NaN mask (atomicOr), and the voxel reads NaN, as a
//    NaN weight makes it NaN in the plain sampler's index backward;
//  - the sums convert back as float(double(sum) * 2^-e).
//  The error against exact sums is at most half of 2^-e a contribution:
//  below max|g| n_samples 2^-60, 1.1e-13 max|g| at 1 x 256 x 512 samples,
//  against the 6e-8 relative rounding of the f32 result.  The int64 sums
//  and the mask (8.1 B a voxel) are scratch the wrapper allocates; only the
//  volume gradient's callers pay for them.
// The sources' and directions' sums are per ray and per pose: one warp a
// ray adds its samples in a fixed order (lane l takes samples l, l + 32, ...,
// then a shuffle tree), and the same warp sum over rays gives each pose's
// source gradient and, for a fan shared by the poses, over poses the fan's;
// no float atomics.
//
// What bounds it on the card: bytes.  With the volume gradient the dense
// (D, H, W) f32 gradient is written (64 MiB at 256^3, 20 us at 3.35 TB/s);
// without it, the value gradient is read (4 B a sample) with the corner
// sectors, as the forward's bound counts them.  The fixed-point scratch adds
// 192 MiB of zeroing and reading at 256^3 (not in the bound).

#include <cfloat>

#include "trilinear_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// The clamp's share of a fraction's gradient df at component p.
__device__ __forceinline__ float clamp_pass(float p, float df, int dim) {
  const float hi = static_cast<float>(dim - 1);
  if (p >= 0.0f && p < hi) return df;
  return p == hi ? df * 0.5f : 0.0f;
}

// The fixed-point scale 2^e from the finite max |g| (see the header).
__device__ __forceinline__ int scale_exponent(const unsigned* gmax, int base) {
  int e;
  frexpf(__uint_as_float(*gmax), &e);
  return base - e;
}

__global__ void __launch_bounds__(kThreads)
    march_bwd_max_kernel(const float* __restrict__ grad, int64_t n, unsigned* gmax) {
  float m = 0.0f;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const float a = fabsf(grad[i]);
    if (a <= FLT_MAX) m = fmaxf(m, a);  // finite only: NaN and inf fail the compare
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_down_sync(kFullMask, m, o));
  if (threadIdx.x % 32 == 0) atomicMax(gmax, __float_as_uint(m));  // order-free: a max
}

__device__ __forceinline__ void add_fixed(unsigned long long* acc, unsigned* nan_mask, int64_t v,
                                          float c, double scale) {
  if (isfinite(c)) {
    const long long f = __double2ll_rn(static_cast<double>(c) * scale);
    if (f != 0) atomicAdd(acc + v, static_cast<unsigned long long>(f));
  } else {
    atomicOr(nan_mask + (v >> 5), 1u << (v & 31));
  }
}

// One sample a thread, flat over (pose, ray, sample): its 8 corner
// contributions into the fixed-point sums.
__global__ void __launch_bounds__(kThreads)
    march_bwd_scatter_kernel(const float* __restrict__ src, const float* __restrict__ dirs,
                          int64_t dir_pose_stride, const float* __restrict__ grad,
                          unsigned long long* acc, unsigned* nan_mask,
                          const unsigned* __restrict__ gmax, int base, int64_t total, int n_rays,
                          int n, float step, int d, int h, int w) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int k = static_cast<int>(i % n);
  const int64_t ray = i / n;
  const int64_t p = ray / n_rays;
  const int r = static_cast<int>(ray % n_rays);
  const float3 pt = march_point(src + 3 * p, dirs + p * dir_pose_stride + 3 * static_cast<int64_t>(r),
                                k, step);
  int x0, x1, y0, y1, z0, z1;
  float fx, fy, fz;
  corner_coords(pt.x, d, x0, x1, fx);
  corner_coords(pt.y, h, y0, y1, fy);
  corner_coords(pt.z, w, z0, z1, fz);
  const float g = grad[i];
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const float dc0 = g * gx, dc1 = g * fx;
  const float dc00 = dc0 * gy, dc01 = dc0 * fy, dc10 = dc1 * gy, dc11 = dc1 * fy;
  const double scale = ldexp(1.0, scale_exponent(gmax, base));
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p00 = x0 * hw + static_cast<int64_t>(y0) * w,
                p01 = x0 * hw + static_cast<int64_t>(y1) * w,
                p10 = x1 * hw + static_cast<int64_t>(y0) * w,
                p11 = x1 * hw + static_cast<int64_t>(y1) * w;
  add_fixed(acc, nan_mask, p00 + z0, dc00 * gz, scale);
  add_fixed(acc, nan_mask, p00 + z1, dc00 * fz, scale);
  add_fixed(acc, nan_mask, p01 + z0, dc01 * gz, scale);
  add_fixed(acc, nan_mask, p01 + z1, dc01 * fz, scale);
  add_fixed(acc, nan_mask, p10 + z0, dc10 * gz, scale);
  add_fixed(acc, nan_mask, p10 + z1, dc10 * fz, scale);
  add_fixed(acc, nan_mask, p11 + z0, dc11 * gz, scale);
  add_fixed(acc, nan_mask, p11 + z1, dc11 * fz, scale);
}

__global__ void __launch_bounds__(kThreads)
    march_bwd_convert_kernel(const long long* __restrict__ acc, const unsigned* __restrict__ nan_mask,
                          const unsigned* __restrict__ gmax, int base, float* __restrict__ out,
                          int64_t nvox) {
  const double inv = ldexp(1.0, -scale_exponent(gmax, base));
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; v < nvox;
       v += static_cast<int64_t>(gridDim.x) * kThreads) {
    const bool nan = ((nan_mask[v >> 5] >> (v & 31)) & 1u) != 0;
    out[v] = nan ? __int_as_float(0x7fc00000) : __double2float_rn(__ll2double_rn(acc[v]) * inv);
  }
}

// One warp a ray (flat over pose, ray): the point gradient of each sample,
// summed over the ray's samples as is (-> the source) and times k * step
// (-> the direction).  src_part, dir_part: (p, n_rays, 3).
__global__ void __launch_bounds__(kThreads)
    march_bwd_point_kernel(const float* __restrict__ vol, const float* __restrict__ src,
                      const float* __restrict__ dirs, int64_t dir_pose_stride,
                      const float* __restrict__ grad, float* __restrict__ src_part,
                      float* __restrict__ dir_part, int64_t rays, int n_rays, int n, float step,
                      int d, int h, int w) {
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (ray >= rays) return;  // warp-uniform
  const int lane = threadIdx.x % 32;
  const int64_t p = ray / n_rays;
  const float* s = src + 3 * p;
  const float* dv = dirs + p * dir_pose_stride + 3 * (ray % n_rays);
  const float* g_ray = grad + ray * n;
  const int64_t hw = static_cast<int64_t>(h) * w;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
  for (int k = lane; k < n; k += 32) {
    const float t = static_cast<float>(k) * step;
    const float3 pt = march_point(s, dv, k, step);
    int x0, x1, y0, y1, z0, z1;
    float fx, fy, fz;
    corner_coords(pt.x, d, x0, x1, fx);
    corner_coords(pt.y, h, y0, y1, fy);
    corner_coords(pt.z, w, z0, z1, fz);
    const float* c00p = vol + x0 * hw + static_cast<int64_t>(y0) * w;
    const float* c01p = vol + x0 * hw + static_cast<int64_t>(y1) * w;
    const float* c10p = vol + x1 * hw + static_cast<int64_t>(y0) * w;
    const float* c11p = vol + x1 * hw + static_cast<int64_t>(y1) * w;
    const float v000 = __ldg(c00p + z0), v001 = __ldg(c00p + z1);
    const float v010 = __ldg(c01p + z0), v011 = __ldg(c01p + z1);
    const float v100 = __ldg(c10p + z0), v101 = __ldg(c10p + z1);
    const float v110 = __ldg(c11p + z0), v111 = __ldg(c11p + z1);
    const float g = g_ray[k];
    const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
    const float c00 = v000 * gz + v001 * fz, c01 = v010 * gz + v011 * fz;
    const float c10 = v100 * gz + v101 * fz, c11 = v110 * gz + v111 * fz;
    const float c0 = c00 * gy + c01 * fy, c1 = c10 * gy + c11 * fy;
    const float dc0 = g * gx, dc1 = g * fx;
    const float dc00 = dc0 * gy, dc01 = dc0 * fy, dc10 = dc1 * gy, dc11 = dc1 * fy;
    const float dfx = g * (c1 - c0);
    const float dfy = dc0 * (c01 - c00) + dc1 * (c11 - c10);
    const float dfz = dc00 * (v001 - v000) + dc01 * (v011 - v010) + dc10 * (v101 - v100) +
                      dc11 * (v111 - v110);
    const float dpx = clamp_pass(pt.x, dfx, d), dpy = clamp_pass(pt.y, dfy, h),
                dpz = clamp_pass(pt.z, dfz, w);
    s0 += dpx;
    s1 += dpy;
    s2 += dpz;
    t0 += dpx * t;
    t1 += dpy * t;
    t2 += dpz * t;
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  t0 = warp_sum(t0);
  t1 = warp_sum(t1);
  t2 = warp_sum(t2);
  if (lane == 0) {
    src_part[3 * ray] = s0;
    src_part[3 * ray + 1] = s1;
    src_part[3 * ray + 2] = s2;
    dir_part[3 * ray] = t0;
    dir_part[3 * ray + 1] = t1;
    dir_part[3 * ray + 2] = t2;
  }
}

// out[o], o = a * n_c + c, = the sum over m < n_m of x[a sa + m sm + c sc],
// one warp an output, in the ray sum's order.
__global__ void __launch_bounds__(kThreads)
    march_bwd_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n_out,
                       int n_c, int64_t n_m, int64_t sa, int64_t sm, int64_t sc) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (o >= n_out) return;  // warp-uniform
  const int lane = threadIdx.x % 32;
  const float* base = x + (o / n_c) * sa + (o % n_c) * sc;
  float acc = 0.0f;
  for (int64_t m = lane; m < n_m; m += 32) acc += base[m * sm];
  acc = warp_sum(acc);
  if (lane == 0) out[o] = acc;
}

cudaError_t strided_sum(const float* x, float* out, int64_t n_out, int n_c, int64_t n_m,
                        int64_t sa, int64_t sm, int64_t sc, cudaStream_t stream) {
  if (n_out == 0) return cudaSuccess;
  const int64_t blocks = (n_out + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  march_bwd_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, out, n_out, n_c,
                                                                            n_m, sa, sm, sc);
  return cudaGetLastError();
}

#define RETURN_IF_FAILED(call)             \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

cudaError_t march_bwd(const float* vol, const float* src, const float* dirs,
                      int64_t dir_pose_stride, const float* grad, int64_t p, int n_rays, int n,
                      float step, int d, int h, int w, float* dvol, long long* acc,
                      unsigned* nan_mask, unsigned* gmax, int base, float* src_part,
                      float* dir_part, float* dsrc_pose, float* dsrc_sum, float* ddir_sum,
                      cudaStream_t stream) {
  const int64_t rays = p * n_rays, total = rays * n;
  if (dvol != nullptr) {
    const int64_t nvox = static_cast<int64_t>(d) * h * w;
    RETURN_IF_FAILED(cudaMemsetAsync(acc, 0, sizeof(long long) * nvox, stream));
    RETURN_IF_FAILED(cudaMemsetAsync(nan_mask, 0, sizeof(unsigned) * ((nvox + 31) / 32), stream));
    RETURN_IF_FAILED(cudaMemsetAsync(gmax, 0, sizeof(unsigned), stream));
    if (total > 0) {
      const int64_t blocks = (total + kThreads - 1) / kThreads;
      if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
      march_bwd_max_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024), kThreads, 0,
                        stream>>>(grad, total, gmax);
      RETURN_IF_FAILED(cudaGetLastError());
      march_bwd_scatter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          src, dirs, dir_pose_stride, grad, reinterpret_cast<unsigned long long*>(acc), nan_mask,
          gmax, base, total, n_rays, n, step, d, h, w);
      RETURN_IF_FAILED(cudaGetLastError());
    }
    if (nvox > 0) {
      const int64_t blocks = (nvox + kThreads - 1) / kThreads;
      march_bwd_convert_kernel<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), kThreads, 0,
                              stream>>>(acc, nan_mask, gmax, base, dvol, nvox);
      RETURN_IF_FAILED(cudaGetLastError());
    }
  }
  if (src_part != nullptr) {
    if (rays > 0) {
      const int64_t blocks = (rays + kWarps - 1) / kWarps;
      if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
      march_bwd_point_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          vol, src, dirs, dir_pose_stride, grad, src_part, dir_part, rays, n_rays, n, step, d, h,
          w);
      RETURN_IF_FAILED(cudaGetLastError());
    }
    // each pose's source: over its rays; then, where asked, over the poses
    RETURN_IF_FAILED(strided_sum(src_part, dsrc_pose, 3 * p, 3, n_rays, 3LL * n_rays, 3, 1,
                                 stream));
    if (dsrc_sum != nullptr)
      RETURN_IF_FAILED(strided_sum(dsrc_pose, dsrc_sum, 3, 3, p, 0, 3, 1, stream));
    // a fan shared by every pose: each ray's direction over the poses
    if (ddir_sum != nullptr)
      RETURN_IF_FAILED(strided_sum(dir_part, ddir_sum, 3LL * n_rays, 3, p, 3, 3LL * n_rays, 1,
                                   stream));
  }
  return cudaSuccess;
}

}  // namespace

// The ray form's backward.  vol: (d, h, w) f32 contiguous; src: (p, 3) f32;
// dirs: rays of 3 f32, ray r of pose q at dirs + q * dir_pose_stride + 3 r (0:
// one fan for every pose); grad: (p, n_rays, n) f32, the values' gradient.
// The volume gradient (dvol (d, h, w) f32) with dvol non-null, and its scratch:
// acc (d h w) int64, nan_mask (ceil(d h w / 32)) uint32, gmax (1) uint32, base
// = 61 - ceil(log2(p n_rays n)).  The points' gradients with src_part
// non-null: src_part and dir_part (p, n_rays, 3) f32 (dir_part: each pose's
// direction gradient), dsrc_pose (p, 3) f32, and where non-null dsrc_sum (3)
// f32, the source's summed over the poses, and ddir_sum (n_rays, 3) f32, the
// directions' summed over the poses.  Launches on `stream`; returns the first
// failing launch's or memset's cudaError_t, else cudaSuccess.
extern "C" int diffus_trilinear_march_bwd(
    const float* vol, const float* src, const float* dirs, int64_t dir_pose_stride,
    const float* grad, int64_t p, int n_rays, int n, float step, int d, int h, int w, float* dvol,
    long long* acc, unsigned* nan_mask, unsigned* gmax, int base, float* src_part, float* dir_part,
    float* dsrc_pose, float* dsrc_sum, float* ddir_sum, void* stream) {
  return static_cast<int>(march_bwd(vol, src, dirs, dir_pose_stride, grad, p, n_rays, n, step, d,
                                    h, w, dvol, acc, nan_mask, gmax, base, src_part, dir_part,
                                    dsrc_pose, dsrc_sum, ddir_sum,
                                    static_cast<cudaStream_t>(stream)));
}
