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
// The sources' and directions' gradients (the points path): the sums are
// per ray, then per pose, then over the poses for a source or fan every
// pose shares, each in a fixed order by index, with no float atomic, so the
// path is deterministic by construction.  The order is the earlier
// one-warp-a-ray design's (lane l of a ray adds samples l, l + 32, ... in
// turn; a warp's shuffle tree over the lanes; the same over the rays and
// the poses), so the gradients are that design's bit for bit: a faster
// order (each of 64 slots a ray summing its own samples) changed their last
// bits, and pose recovery's chaotic full-width descent then ended worse
// than it began (PERF.md).  Two launches:
// - the point kernel: a block is 8 rays x 32 lanes that march the rays to
//   their ends, the lanes of 4 rays first, so a warp is a patch of 4 rays x
//   8 samples as in K2's forward; one warp sums a ray's 32 lanes from
//   shared memory; each ray's source and direction are loaded once; 32-bit
//   voxel offsets where the volume allows; the corners by 8 scalar loads;
// - the sums kernel: a warp a pose's source component (one block where a
//   sum runs over the poses).
// Timed at recovery's 8 poses x 256 rays x 512 samples on the 256^3
// phantom, on the recovery step's own inputs, with L2 flushed before each
// call (as the step's other kernels leave it) and back to back
// (chip_smoke.py --recovery-step, the variants in edited copies of this
// file; NVIDIA H100 80GB HBM3, 700 W):
// - shipped: 21.0 and 19.2 us; the earlier design (a warp a ray, its sums
//   in a second kernel) 25.8-26.5 and 24.2-24.4 us on the same inputs;
// - the corners as K2 reads them (one float4 for z0 and z1 where aligned,
//   else two scalar loads): 25.9 and 20.6 us, and 23.7 against 20.3 us on
//   fans with noise; only where the whole warp can pair: 24.2 and 19.8 us
//   (a warp whose lanes split between the two paths runs both, likely);
// - other patches: 8 x 4 21.6 and 19.3 us, 2 x 16 22.6 and 21.0, a warp a
//   ray (1 x 32) 28.7 and 24.4;
// - the sums in the point kernel, by the last block of each pose to take a
//   ticket (one launch): 0.1-0.5 us faster, within two runs' spread, for a
//   ticket buffer kept between calls; the sums kernel in one block 23.5 and
//   22.1 us;
// - 2 or 4 samples in flight a lane, or a block's box of voxels staged in
//   shared memory: slower on every input (PERF.md).
// What bounds it now: not bytes (7.8 MB, 2.3 us).  The march alone (no
// trees, no sums kernel) takes 17.6 and 15.6 us; without the corner
// gathers 15.1 and 10.9 us, without the grad load either 10.2 us: ~170
// instructions a sample (--fmad=false) from 16 warps an SM.

#include <cfloat>

#include "trilinear_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

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

// --- the points' gradients: the sources' and the directions' -------------

// A block is kRays adjacent rays of one pose x kLanes lanes a ray, which
// march the rays to their ends.  Lane l of a ray adds the terms of samples
// l, l + 32, l + 64, ... in turn, and a ray's 32 lanes meet in the halving
// tree of a warp's shuffle-down sum: the order of the one-warp-a-ray design,
// so the gradients are that design's bit for bit.  Threads run across kPatchRays
// rays first, then the lanes, so a warp is a patch of 4 rays x 8
// consecutive samples, as K2's ray form tiles them (trilinear.cu).
constexpr int kRays = 8;
constexpr int kLanes = 32;
constexpr int kPatchRays = 4;       // the rays of a warp's patch
constexpr int kSums = 6;            // a ray's source (3) and direction (3) sums
// Blocks an SM must hold (at most 64 registers a thread): 4 x 132 SMs take
// recovery's 8 x 32 blocks in one wave.
constexpr int kPointBlocks = 4;
static_assert(kRays == kWarps, "a warp sums each ray's lanes");

// One sample's point, corners and fractions, as trilinear_at computes them.
struct Sample {
  float3 pt;
  float fx, fy, fz, g, t;
  int x0, x1, y0, y1, z0, z1;
  bool in;
};

// Sample k of a ray from source s along direction dv: march_point's three
// roundings, from the ray's source and direction held in registers.  A ray
// past the last (`in` false) gets a point too, which no sum takes, and no
// grad.
__device__ __forceinline__ Sample make_sample(float3 s, float3 dv, const float* __restrict__ g_ray,
                                              bool ray_in, int64_t k, float step, int d, int h,
                                              int w) {
  Sample c;
  c.in = ray_in;
  c.t = static_cast<float>(k) * step;
  c.pt = make_float3(s.x + c.t * dv.x, s.y + c.t * dv.y, s.z + c.t * dv.z);
  c.g = c.in ? __ldg(g_ray + k) : 0.0f;
  corner_coords(c.pt.x, d, c.x0, c.x1, c.fx);
  corner_coords(c.pt.y, h, c.y0, c.y1, c.fy);
  corner_coords(c.pt.z, w, c.z0, c.z1, c.fz);
  return c;
}

// The 8 corners of a sample from the volume: z0 and z1 of each (x, y)
// column, 8 scalar loads.  Off: int where the volume's voxels fit in an int
// (fewer instructions than 64-bit offsets), else int64_t.
template <typename Off>
__device__ __forceinline__ void load_corners(const float* __restrict__ vol, const Sample& c,
                                             int h, int w, float* v) {
  const Off hw = static_cast<Off>(h) * w;
  const float* plane0 = vol + c.x0 * hw;
  const float* plane1 = vol + c.x1 * hw;
  const Off by0 = static_cast<Off>(c.y0) * w, by1 = static_cast<Off>(c.y1) * w;
  const float* col[4] = {plane0 + by0, plane0 + by1, plane1 + by0, plane1 + by1};
#pragma unroll
  for (int q = 0; q < 4; ++q) v[2 * q] = __ldg(col[q] + c.z0), v[2 * q + 1] = __ldg(col[q] + c.z1);
}

// The point gradient of a sample through the clamp, from its 8 corners v
// (v000, v001, v010, v011, v100, v101, v110, v111): the header's dfx, dfy,
// dfz into t[0..2] (the source's terms) and times k * step into t[3..5]
// (the direction's); +0.0 for a ray past the last (which changes no sum: a
// sum from +0.0 is never -0.0).
__device__ __forceinline__ void point_terms(const Sample& c, const float* v, int d, int h, int w,
                                            float* t) {
  const float gx = 1.0f - c.fx, gy = 1.0f - c.fy, gz = 1.0f - c.fz;
  const float c00 = v[0] * gz + v[1] * c.fz, c01 = v[2] * gz + v[3] * c.fz;
  const float c10 = v[4] * gz + v[5] * c.fz, c11 = v[6] * gz + v[7] * c.fz;
  const float c0 = c00 * gy + c01 * c.fy, c1 = c10 * gy + c11 * c.fy;
  const float dc0 = c.g * gx, dc1 = c.g * c.fx;
  const float dc00 = dc0 * gy, dc01 = dc0 * c.fy, dc10 = dc1 * gy, dc11 = dc1 * c.fy;
  const float dfx = c.g * (c1 - c0);
  const float dfy = dc0 * (c01 - c00) + dc1 * (c11 - c10);
  const float dfz = dc00 * (v[1] - v[0]) + dc01 * (v[3] - v[2]) + dc10 * (v[5] - v[4]) +
                    dc11 * (v[7] - v[6]);
  t[0] = c.in ? clamp_pass(c.pt.x, dfx, d) : 0.0f;
  t[1] = c.in ? clamp_pass(c.pt.y, dfy, h) : 0.0f;
  t[2] = c.in ? clamp_pass(c.pt.z, dfz, w) : 0.0f;
  t[3] = c.in ? t[0] * c.t : 0.0f;
  t[4] = c.in ? t[1] * c.t : 0.0f;
  t[5] = c.in ? t[2] * c.t : 0.0f;
}

// The sum of x over a warp's lanes as a shuffle-down tree takes it (halving:
// x[l] + x[l + 16], then + 8, 4, 2, 1); lane 0 holds it.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFullMask, x, o);
  return x;
}

// The points' gradients, in a fixed order (no float atomics), the
// one-warp-a-ray design's.  The point kernel: each lane of a ray adds its
// samples' 6 terms in turn to 0, and a ray's 32 lanes meet in a halving
// tree: each ray's direction gradient (-> ddir_pose) and source sum (->
// ray_src).
template <typename Off>
__global__ void __launch_bounds__(kThreads, kPointBlocks)
    march_bwd_point_kernel(const float* __restrict__ vol, const float* __restrict__ src,
                           const float* __restrict__ dirs, int64_t dir_pose_stride,
                           const float* __restrict__ grad, int n_rays, int n, float step, int d,
                           int h, int w, float* __restrict__ ray_src,
                           float* __restrict__ ddir_pose) {
  constexpr int kGroup = kPatchRays * kLanes;  // the threads of kPatchRays rays
  __shared__ float lane_sums[kRays][kLanes][kSums];
  const int r_tiles = (n_rays + kRays - 1) / kRays;
  const int64_t pose = blockIdx.x / r_tiles;
  const int r0 = static_cast<int>(blockIdx.x % r_tiles) * kRays;
  const int rr = threadIdx.x / kGroup * kPatchRays + threadIdx.x % kPatchRays;  // ray in block
  const int lane_of_ray = threadIdx.x % kGroup / kPatchRays;
  const int r = r0 + rr;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  const bool ray_in = r < n_rays;
  float3 s0 = make_float3(0.0f, 0.0f, 0.0f), dv = s0;
  if (ray_in) {
    const float* ray_dir = dirs + pose * dir_pose_stride + 3 * static_cast<int64_t>(r);
    s0 = make_float3(__ldg(src + 3 * pose), __ldg(src + 3 * pose + 1), __ldg(src + 3 * pose + 2));
    dv = make_float3(__ldg(ray_dir), __ldg(ray_dir + 1), __ldg(ray_dir + 2));
  }
  const float* g_ray = grad + (pose * n_rays + r) * n;
  float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t k = lane_of_ray; k < n; k += kLanes) {
    const Sample c = make_sample(s0, dv, g_ray, ray_in, k, step, d, h, w);
    float v[8] = {};
    if (c.in) load_corners<Off>(vol, c, h, w, v);
    float t[kSums];
    point_terms(c, v, d, h, w, t);
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] += t[q];
  }
#pragma unroll
  for (int q = 0; q < kSums; ++q) lane_sums[rr][lane_of_ray][q] = acc[q];
  __syncthreads();
  // warp w sums ray w's lanes (kRays == kWarps)
  float x[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) x[q] = warp_sum(lane_sums[warp][lane][q]);
  if (lane == 0 && r0 + warp < n_rays) {
    const int64_t at = (pose * n_rays + r0 + warp) * 3;
#pragma unroll
    for (int q = 0; q < 3; ++q) ray_src[at + q] = x[q], ddir_pose[at + q] = x[3 + q];
  }
}

// The sums after the rays', the point kernel's second launch.  Warp t of
// the grid takes pose t / 3's source component t % 3: lane l adds the
// source sums of rays l, l + 32, ... in turn to 0, then a warp's halving
// tree (-> dsrc_pose).  With dsrc_sum or ddir_sum the grid is one block,
// which then sums over the poses the same way: lane l takes poses l, l + 32,
// ..., then the tree.
__global__ void __launch_bounds__(kThreads)
    march_bwd_point_sums_kernel(const float* __restrict__ ray_src, float* dsrc_pose,
                                const float* __restrict__ ddir_pose, float* __restrict__ dsrc_sum,
                                float* __restrict__ ddir_sum, int n_poses, int n_rays) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int t = blockIdx.x * kWarps + warp; t < 3 * n_poses; t += kWarps * gridDim.x) {
    const int64_t pose = t / 3;
    const int c = t % 3;
    float x = 0.0f;
    for (int i = lane; i - lane < n_rays; i += 32)
      x += i < n_rays ? ray_src[(pose * n_rays + i) * 3 + c] : 0.0f;
    x = warp_sum(x);
    if (lane == 0) dsrc_pose[pose * 3 + c] = x;
  }
  if (dsrc_sum == nullptr && ddir_sum == nullptr) return;
  __syncthreads();  // one block: every pose's sums are written
  if (dsrc_sum != nullptr && warp < 3) {
    float x = 0.0f;
    for (int q = lane; q - lane < n_poses; q += 32)
      x += q < n_poses ? dsrc_pose[3 * q + warp] : 0.0f;
    x = warp_sum(x);
    if (lane == 0) dsrc_sum[warp] = x;
  }
  if (ddir_sum != nullptr) {
    for (int64_t o = warp; o < 3LL * n_rays; o += kWarps) {  // one warp an output
      float x = 0.0f;
      for (int q = lane; q - lane < n_poses; q += 32)
        x += q < n_poses ? ddir_pose[3LL * n_rays * q + o] : 0.0f;
      x = warp_sum(x);
      if (lane == 0) ddir_sum[o] = x;
    }
  }
}

cudaError_t launch_points(const float* vol, const float* src, const float* dirs,
                          int64_t dir_pose_stride, const float* grad, int64_t p, int n_rays,
                          int n, float step, int d, int h, int w, float* ray_src,
                          float* dsrc_pose, float* ddir_pose, float* dsrc_sum, float* ddir_sum,
                          cudaStream_t stream) {
  const int64_t blocks = p * ((n_rays + kRays - 1) / kRays);
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (static_cast<int64_t>(d) * h * w <= INT_MAX) {
    march_bwd_point_kernel<int><<<grid, kThreads, 0, stream>>>(
        vol, src, dirs, dir_pose_stride, grad, n_rays, n, step, d, h, w, ray_src, ddir_pose);
  } else {
    march_bwd_point_kernel<int64_t><<<grid, kThreads, 0, stream>>>(
        vol, src, dirs, dir_pose_stride, grad, n_rays, n, step, d, h, w, ray_src, ddir_pose);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned sum_blocks = dsrc_sum != nullptr || ddir_sum != nullptr
                                  ? 1u
                                  : static_cast<unsigned>((3 * p + kWarps - 1) / kWarps);
  march_bwd_point_sums_kernel<<<sum_blocks, kThreads, 0, stream>>>(
      ray_src, dsrc_pose, ddir_pose, dsrc_sum, ddir_sum, static_cast<int>(p), n_rays);
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
                      unsigned* masks, int base, float* dsrc_pose, float* ddir_pose,
                      float* dsrc_sum, float* ddir_sum, float* ray_src,
                      cudaStream_t stream) {
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
  if (dsrc_pose != nullptr && p > 0 && n_rays > 0 && n > 0) {
    return launch_points(vol, src, dirs, dir_pose_stride, grad, p, n_rays, n, step, d, h, w,
                         ray_src, dsrc_pose, ddir_pose, dsrc_sum, ddir_sum, stream);
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
// ceil(log2(p n_rays n)).  The points' gradients with dsrc_pose non-null:
// dsrc_pose (p, 3) f32 and ddir_pose (p, n_rays, 3) f32, each pose's source
// and direction gradients, and where non-null dsrc_sum (3) f32, the source's
// summed over the poses, and ddir_sum (n_rays, 3) f32, the directions'
// summed over the poses; their scratch: ray_src (p, n_rays, 3) f32, the
// rays' source sums.  Launches on `stream`; returns the first failing launch's or memset's
// cudaError_t, else cudaSuccess.
extern "C" int diffus_trilinear_march_bwd(
    const float* vol, const float* src, const float* dirs, int64_t dir_pose_stride,
    const float* grad, int64_t p, int n_rays, int n, float step, int d, int h, int w, float* dvol,
    long long* acc, unsigned* masks, int base, float* dsrc_pose, float* ddir_pose,
    float* dsrc_sum, float* ddir_sum, float* ray_src, void* stream) {
  return static_cast<int>(march_bwd(vol, src, dirs, dir_pose_stride, grad, p, n_rays, n, step, d,
                                    h, w, dvol, acc, masks, base, dsrc_pose, ddir_pose, dsrc_sum,
                                    ddir_sum, ray_src, static_cast<cudaStream_t>(stream)));
}
