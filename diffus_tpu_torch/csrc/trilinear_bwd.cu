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
//  against the 6e-8 relative rounding of the f32 result.
// Only the voxels the rays touch are summed (training's 256-ray fan in one
// plane touches 53 718 of the 16.7 M voxels of a 256^3 volume), and no
// state is kept between calls:
//  1. one memset zeroes a touched bitmap, the NaN mask (1 bit a voxel each)
//     and the max;
//  2. the mark pass recomputes each sample's corners, stores 0 into their
//     int64 sums (equal stores: their race is harmless), sets their touched
//     bits and folds the finite max |g| (one atomicMax a block);
//  3. the scatter adds the contributions (order-free integer atomics);
//  4. the convert writes the dense f32 gradient once: NaN where the NaN bit
//     is set, the converted sum where the touched bit is (the only reads of
//     the sums), +0.0 elsewhere, a warp to 1024 voxels in float4 stores.
// Samples clamped to the volume's faces pile up on a few voxels (19 698 of
// training's 1 M corner touches land on one), and atomics on one address
// run one after another.  So in passes 2 and 3 a warp's lanes, consecutive
// samples of a ray, first merge runs of adjacent lanes on the same voxel
// (a segmented shuffle scan of the int64 terms, exact): one atomic a run.
// The int64 sums are addressed by voxel (d h w slots, allocated but neither
// zeroed nor read outside the touched ones); the masks are 0.25 B a voxel.
// The sources' and directions' sums are per ray and per pose: one warp a
// ray adds its samples in a fixed order (lane l takes samples l, l + 32, ...,
// then a shuffle tree), and the same warp sum over rays gives each pose's
// source gradient and, for a fan shared by the poses, over poses the fan's;
// no float atomics.
//
// What bounds it on the card: bytes.  With the volume gradient the dense
// (D, H, W) f32 gradient is written (64 MiB at 256^3, 20 us at 3.35 TB/s);
// the scratch adds the masks (4 MiB zeroed and read at 256^3) and ~24 B a
// touched voxel (its sum zeroed, added to and read).  Without it, the value
// gradient is read (4 B a sample) with the corner sectors, as the forward's
// bound counts them.

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

// Sample i (flat over pose, ray, sample) of the ray form: its corners' rows
// (flat voxel index of z = 0) and z, and its fractions, as the forward
// computes them.
struct Corners {
  int64_t p00, p01, p10, p11;
  int z0, z1;
  float fx, fy, fz;
};

__device__ __forceinline__ Corners sample_corners(const float* __restrict__ src,
                                                  const float* __restrict__ dirs,
                                                  int64_t dir_pose_stride, int64_t i, int n_rays,
                                                  int n, float step, int d, int h, int w) {
  const int k = static_cast<int>(i % n);
  const int64_t ray = i / n;
  const int64_t p = ray / n_rays;
  const int r = static_cast<int>(ray % n_rays);
  const float3 pt =
      march_point(src + 3 * p, dirs + p * dir_pose_stride + 3 * static_cast<int64_t>(r), k, step);
  Corners c;
  int x0, x1, y0, y1;
  corner_coords(pt.x, d, x0, x1, c.fx);
  corner_coords(pt.y, h, y0, y1, c.fy);
  corner_coords(pt.z, w, c.z0, c.z1, c.fz);
  const int64_t hw = static_cast<int64_t>(h) * w;
  c.p00 = x0 * hw + static_cast<int64_t>(y0) * w;
  c.p01 = x0 * hw + static_cast<int64_t>(y1) * w;
  c.p10 = x1 * hw + static_cast<int64_t>(y0) * w;
  c.p11 = x1 * hw + static_cast<int64_t>(y1) * w;
  return c;
}

// The warp's lanes hold one sample each, in order along the rays, so a
// voxel is often a key of adjacent lanes (a ray's samples clamped to the
// volume's faces land on one voxel by the hundred).  A run is a maximal
// stretch of adjacent lanes with equal keys; its last lane, the tail, does
// the run's one global operation.  A lane past the samples' end has a key
// of its own (no voxel).
__device__ __forceinline__ bool run_tail(long long key, int lane) {
  const long long right = __shfl_down_sync(kFullMask, key, 1);  // every lane shuffles
  return lane == 31 || right != key;
}

// Zero the sums of voxels z0 and z1 of a row and set their touched bits,
// unless both bits are set already (read from L2): a pile-up's later runs
// then neither store nor take an atomic.  The scatter runs after this pass
// ends, so every zero is stored before any sum is added.
__device__ __forceinline__ void mark_pair(long long* acc, unsigned* touched, int64_t row, int z0,
                                          int z1) {
  const int64_t v0 = row + z0, v1 = row + z1;
  if ((v0 >> 5) == (v1 >> 5)) {
    const unsigned bits = (1u << (v0 & 31)) | (1u << (v1 & 31));
    if ((__ldcg(touched + (v0 >> 5)) & bits) == bits) return;  // zeroed in this pass already
  }
  acc[v0] = 0;
  acc[v1] = 0;
  if ((v0 >> 5) == (v1 >> 5)) {
    atomicOr(touched + (v0 >> 5), (1u << (v0 & 31)) | (1u << (v1 & 31)));
  } else {
    atomicOr(touched + (v0 >> 5), 1u << (v0 & 31));
    atomicOr(touched + (v1 >> 5), 1u << (v1 & 31));
  }
}

// One sample a thread: zero the sums of its 8 corners and set their touched
// bits, once a run of lanes with the same row and z0; the block's finite
// max |g| into gmax (an order-free max).
__global__ void __launch_bounds__(kThreads)
    march_bwd_mark_kernel(const float* __restrict__ src, const float* __restrict__ dirs,
                          int64_t dir_pose_stride, const float* __restrict__ grad,
                          long long* acc, unsigned* touched, unsigned* gmax, int64_t total,
                          int n_rays, int n, float step, int d, int h, int w) {
  __shared__ float warp_max[kWarps];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const bool in = i < total;
  Corners c{};
  float m = 0.0f;
  if (in) {
    c = sample_corners(src, dirs, dir_pose_stride, i, n_rays, n, step, d, h, w);
    const float a = fabsf(grad[i]);
    if (a <= FLT_MAX) m = a;  // finite only: NaN and inf fail the compare
  }
  for (const int64_t row : {c.p00, c.p01, c.p10, c.p11}) {
    const long long key = in ? row + c.z0 : -1 - lane;
    if (run_tail(key, lane) && in) mark_pair(acc, touched, row, c.z0, c.z1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_down_sync(kFullMask, m, o));
  if (lane == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) m = fmaxf(m, warp_max[k]);
    atomicMax(gmax, __float_as_uint(m));  // non-negative floats order as their bits
  }
}

// Corner contribution c of voxel v into the fixed-point sums: round-half-even
// (c * scale), summed over the run of lanes with the same voxel into its
// tail (a segmented scan), which adds the run's sum with one integer atomic
// and sets the NaN bit if a contribution of the run is not finite.  Integer
// sums are exact, so the grouping changes no bit.
__device__ __forceinline__ void add_fixed(unsigned long long* acc, unsigned* nan_mask, bool in,
                                          int64_t v, float c, double scale, int lane) {
  const bool finite = isfinite(c);
  long long f = in && finite ? __double2ll_rn(static_cast<double>(c) * scale) : 0;
  const long long key = in ? v : -1 - lane;
  const long long left = __shfl_up_sync(kFullMask, key, 1);
  const unsigned heads = __ballot_sync(kFullMask, lane == 0 || left != key);
  const unsigned bad = __ballot_sync(kFullMask, in && !finite);
  const unsigned upto = 0xffffffffu >> (31 - lane);  // lanes 0..lane
  const int head = 31 - __clz(heads & upto);
  if (heads != kFullMask) {  // some run is longer than a lane (warp-uniform)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(kFullMask, f, o);
      if (lane - o >= head) f += u;
    }
  }
  if (run_tail(key, lane) && in) {
    if (bad & upto & ~((1u << head) - 1u)) atomicOr(nan_mask + (v >> 5), 1u << (v & 31));
    if (f != 0) atomicAdd(acc + v, static_cast<unsigned long long>(f));
  }
}

// One sample a thread: its 8 corner contributions into the fixed-point sums.
__global__ void __launch_bounds__(kThreads)
    march_bwd_scatter_kernel(const float* __restrict__ src, const float* __restrict__ dirs,
                          int64_t dir_pose_stride, const float* __restrict__ grad,
                          unsigned long long* acc, unsigned* nan_mask,
                          const unsigned* __restrict__ gmax, int base, int64_t total, int n_rays,
                          int n, float step, int d, int h, int w) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const bool in = i < total;  // no early exit: every lane takes part in the runs' shuffles
  Corners c{};
  float g = 0.0f;
  if (in) {
    c = sample_corners(src, dirs, dir_pose_stride, i, n_rays, n, step, d, h, w);
    g = grad[i];
  }
  const float gx = 1.0f - c.fx, gy = 1.0f - c.fy, gz = 1.0f - c.fz;
  const float dc0 = g * gx, dc1 = g * c.fx;
  const float dc00 = dc0 * gy, dc01 = dc0 * c.fy, dc10 = dc1 * gy, dc11 = dc1 * c.fy;
  const double scale = ldexp(1.0, scale_exponent(gmax, base));
  add_fixed(acc, nan_mask, in, c.p00 + c.z0, dc00 * gz, scale, lane);
  add_fixed(acc, nan_mask, in, c.p00 + c.z1, dc00 * c.fz, scale, lane);
  add_fixed(acc, nan_mask, in, c.p01 + c.z0, dc01 * gz, scale, lane);
  add_fixed(acc, nan_mask, in, c.p01 + c.z1, dc01 * c.fz, scale, lane);
  add_fixed(acc, nan_mask, in, c.p10 + c.z0, dc10 * gz, scale, lane);
  add_fixed(acc, nan_mask, in, c.p10 + c.z1, dc10 * c.fz, scale, lane);
  add_fixed(acc, nan_mask, in, c.p11 + c.z0, dc11 * gz, scale, lane);
  add_fixed(acc, nan_mask, in, c.p11 + c.z1, dc11 * c.fz, scale, lane);
}

// Voxel v's gradient from its touched and NaN bits: NaN, the converted sum
// (the only read of the sums) or +0.0.
__device__ __forceinline__ float voxel_gradient(const long long* __restrict__ acc, int64_t v,
                                                unsigned touched, unsigned nan, double inv) {
  if (nan) return __int_as_float(0x7fc00000);
  return touched ? __double2float_rn(__ll2double_rn(acc[v]) * inv) : 0.0f;
}

constexpr int kGroup = 1024;  // voxels a warp converts: 32 mask words

// One warp a group of 1024 voxels: lane l reads the group's mask words l,
// then the warp writes the group as 8 rows of float4 with streaming stores,
// each lane taking its 4 voxels' bits from the lane that read their word; the
// last, partial group goes voxel by voxel.
__global__ void __launch_bounds__(kThreads)
    march_bwd_convert_kernel(const long long* __restrict__ acc,
                          const unsigned* __restrict__ touched,
                          const unsigned* __restrict__ nan_mask,
                          const unsigned* __restrict__ gmax, int base, float* __restrict__ out,
                          int64_t nvox) {
  const int64_t v0 = (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) * kGroup;
  if (v0 >= nvox) return;  // warp-uniform
  const int lane = threadIdx.x % 32;
  const double inv = ldexp(1.0, -scale_exponent(gmax, base));
  if (v0 + kGroup <= nvox) {
    const unsigned tw = touched[v0 / 32 + lane], nw = nan_mask[v0 / 32 + lane];
#pragma unroll
    for (int j = 0; j < kGroup / 128; ++j) {
      const int from = 4 * j + lane / 8, shift = 4 * (lane % 8);
      const unsigned t4 = (__shfl_sync(kFullMask, tw, from) >> shift) & 0xfu;
      const unsigned n4 = (__shfl_sync(kFullMask, nw, from) >> shift) & 0xfu;
      const int64_t v = v0 + 4 * (32 * j + lane);
      float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t4 | n4) {
        o.x = voxel_gradient(acc, v, t4 & 1u, n4 & 1u, inv);
        o.y = voxel_gradient(acc, v + 1, t4 & 2u, n4 & 2u, inv);
        o.z = voxel_gradient(acc, v + 2, t4 & 4u, n4 & 4u, inv);
        o.w = voxel_gradient(acc, v + 3, t4 & 8u, n4 & 8u, inv);
      }
      __stcs(reinterpret_cast<float4*>(out + v), o);  // evict-first: 64 MiB would flush L2
    }
  } else {
    for (int64_t v = v0 + lane; v < nvox; v += 32) {
      const unsigned bit = 1u << (v & 31);
      out[v] = voxel_gradient(acc, v, touched[v >> 5] & bit, nan_mask[v >> 5] & bit, inv);
    }
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
                      unsigned* masks, int base, float* src_part, float* dir_part,
                      float* dsrc_pose, float* dsrc_sum, float* ddir_sum, cudaStream_t stream) {
  const int64_t rays = p * n_rays, total = rays * n;
  if (dvol != nullptr) {
    const int64_t nvox = static_cast<int64_t>(d) * h * w, words = (nvox + 31) / 32;
    unsigned* const touched = masks;
    unsigned* const nan_mask = masks + words;
    unsigned* const gmax = masks + 2 * words;
    RETURN_IF_FAILED(cudaMemsetAsync(masks, 0, sizeof(unsigned) * (2 * words + 1), stream));
    if (total > 0) {
      const int64_t blocks = (total + kThreads - 1) / kThreads;
      if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
      march_bwd_mark_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          src, dirs, dir_pose_stride, grad, acc, touched, gmax, total, n_rays, n, step, d, h, w);
      RETURN_IF_FAILED(cudaGetLastError());
      march_bwd_scatter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          src, dirs, dir_pose_stride, grad, reinterpret_cast<unsigned long long*>(acc), nan_mask,
          gmax, base, total, n_rays, n, step, d, h, w);
      RETURN_IF_FAILED(cudaGetLastError());
    }
    if (nvox > 0) {
      const int64_t groups = (nvox + kGroup - 1) / kGroup, blocks = (groups + kWarps - 1) / kWarps;
      if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
      march_bwd_convert_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          acc, touched, nan_mask, gmax, base, dvol, nvox);
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
// The volume gradient (dvol (d, h, w) f32, 16-byte aligned) with dvol
// non-null, and its scratch: acc (d h w) int64, neither zeroed nor read
// outside the touched voxels; masks (2 ceil(d h w / 32) + 1) uint32: the
// touched bitmap, the NaN mask and the max |g|, zeroed here; base = 61 -
// ceil(log2(p n_rays n)).  The points' gradients with src_part
// non-null: src_part and dir_part (p, n_rays, 3) f32 (dir_part: each pose's
// direction gradient), dsrc_pose (p, 3) f32, and where non-null dsrc_sum (3)
// f32, the source's summed over the poses, and ddir_sum (n_rays, 3) f32, the
// directions' summed over the poses.  Launches on `stream`; returns the first
// failing launch's or memset's cudaError_t, else cudaSuccess.
extern "C" int diffus_trilinear_march_bwd(
    const float* vol, const float* src, const float* dirs, int64_t dir_pose_stride,
    const float* grad, int64_t p, int n_rays, int n, float step, int d, int h, int w, float* dvol,
    long long* acc, unsigned* masks, int base, float* src_part, float* dir_part, float* dsrc_pose,
    float* dsrc_sum, float* ddir_sum, void* stream) {
  return static_cast<int>(march_bwd(vol, src, dirs, dir_pose_stride, grad, p, n_rays, n, step, d,
                                    h, w, dvol, acc, masks, base, src_part, dir_part,
                                    dsrc_pose, dsrc_sum, ddir_sum,
                                    static_cast<cudaStream_t>(stream)));
}
