// Nearest volume sample along rays (kernel K5), in one launch.
//
// Replaces no Pallas kernel: the JAX package samples nearest with XLA ops
// (ray points, round, clamp and a gather: diffus_tpu/ops/sampling.py:51-69,
// reached from trace_rays, diffus_tpu/render/renderer.py:131-150), which XLA
// fuses on the TPU.  In plain PyTorch the same chain (ray_points,
// _round_idx, sample_nearest in diffus_tpu_torch/ops/sampling.py) is ~10
// passes over a (..., n_rays, n, 3) point tensor: the points written, then
// nan_to_num, clamp, minimum and round each reading and writing them, two
// integer casts and the three index tensors of one gather, ~1 GB of traffic
// for a 32-pose chunk of the service at 256 rays x 512 samples.
//
// The kernel (nearest_march_kernel, diffus_nearest_march) marches the rays
// itself: sample k of ray r of pose p is at source[p] + (k * step) *
// dir[p, r], ray_points' three IEEE roundings (march_coord; built with
// --fmad=false, as the whole library is), clamps each component in floats to
// [0, dim - 1] and rounds it half to even (round_clamp: fmaxf/fminf send NaN
// to 0 and +-inf to the bounds, as nan_to_num, clamp and minimum do), loads
// the one voxel and writes it.  The idx (int32, (..., n_rays, n, 3)) is
// written only when the caller passes an idx buffer: the service, pose
// recovery and the mesh read the values alone, render_frame and
// render_sweep the idx too.  Flat offsets are 64-bit.  So values and idx
// are sample_nearest(volume, ray_points(...))'s bit for bit.
//
// One body serves every routed dtype.  A gather copies bits, so the volume
// is read and written as unsigned integers of its element's width: 2 bytes
// (bfloat16, float16), 4 (float32) or 8 (float64).  The points are computed
// in the sources' and directions' types, float or double, promoted as
// PyTorch promotes them.
//
// The bound (chip_smoke.py's rule: each input read once, each output
// written once).  At the service's 32 poses x 256 rays x 512 samples on the
// 256^3 phantom: 4 B of value a sample, the distinct 32-byte volume sectors
// the samples touch (about 1.9 MB), 6 floats a ray: ~17.8 MB, ~5.3 us at
// 3.35 TB/s.  With the idx, 16 B a sample.  The working set is the touched
// sectors, which live in L2; what sets the pace is the lines each load
// instruction touches and the output stream.
//
// Design, each item chosen by timing the variants at the service's chunk
// (values only) and at the lung view (256 x 200 x 100 with idx on a 512^3
// volume), device time a launch in a CUDA graph (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md): threads run across rays first, so a warp is a patch of
// adjacent rays x consecutive samples (4 rays as shipped: near the apex
// neighbouring rays read the same voxels), and
// - values only: 4 consecutive samples a thread (a warp 4 rays x 32
//   samples), their 4 loads in flight, one 16-byte store: 14.1 us, against
//   29.0 us with one sample a thread (K2's 4 x 8 patch; 2, 8 or 16 rays
//   28.9-29.9, 32 rays x 1 72.9), 16.7-19.4 with 2 or 4 samples a thread
//   64 apart, 16.3 and 17.7 with 8 and 16 rays of 4 consecutive samples;
// - with the idx: one sample a thread, a warp 4 rays x 8 samples, 12 bytes
//   of idx in three 4-byte stores: 32.2 us at the service's chunk and 49.4
//   at the lung view, against 43.9 and 59.6 with 4 consecutive samples and
//   16-byte stores, 64.6 and 95.2 with 8 rays;
// - every store streaming (st.global.cs), so that the output does not push
//   the volume's lines out of L2: 14.1 -> 13.9, 32.2 -> 31.4, 49.4 -> 48.4.
// The 16-byte stores need rows of a multiple of 4 samples and an output
// aligned to 4 elements (vec); otherwise the same body stores 4 scalars.

#include "trilinear_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 4;
constexpr int kAlong = kThreads / kRays;   // samples a block with the idx
constexpr int kPer = 4;                    // consecutive samples a thread, values only
constexpr int kAlongValues = kAlong * kPer;

// Four elements of 2, 4 or 8 bytes in 8, 16 or 32 bytes of streaming stores.
__device__ __forceinline__ void store4(uint16_t* p, const uint16_t (&v)[kPer]) {
  __stcs(reinterpret_cast<ushort4*>(p), make_ushort4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store4(uint32_t* p, const uint32_t (&v)[kPer]) {
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store4(unsigned long long* p,
                                       const unsigned long long (&v)[kPer]) {
  __stcs(reinterpret_cast<ulonglong2*>(p), make_ulonglong2(v[0], v[1]));
  __stcs(reinterpret_cast<ulonglong2*>(p) + 1, make_ulonglong2(v[2], v[3]));
}

// The flat index of the nearest voxel to sample k of the ray (s, dv), and
// its three coordinates.
template <typename S, typename D>
__device__ __forceinline__ int64_t voxel(const S* s, const D* dv, int k, D step, int d, int h,
                                         int w, int& x, int& y, int& z) {
  x = round_clamp(march_coord(s, dv, k, step), d);
  y = round_clamp(march_coord(s + 1, dv + 1, k, step), h);
  z = round_clamp(march_coord(s + 2, dv + 2, k, step), w);
  return (static_cast<int64_t>(x) * h + y) * w + z;
}

// T: the volume's element as an unsigned integer of its width; S, D: the
// sources' and directions' float types; kIdx: whether the idx is written.
// A block is kRays adjacent rays x kAlong (with the idx) or kAlongValues
// (values only) consecutive samples of one pose; the flat block index runs
// over (pose, ray tile, sample tile), sample tile fastest.
template <typename T, typename S, typename D, bool kIdx>
__global__ void __launch_bounds__(kThreads)
    nearest_march_kernel(const T* __restrict__ vol, const S* __restrict__ src,
                         const D* __restrict__ dirs, int64_t dir_pose_stride,
                         T* __restrict__ out, int32_t* __restrict__ idx, int n_rays, int n,
                         D step, int d, int h, int w, bool vec) {
  constexpr int along = kIdx ? kAlong : kAlongValues;
  constexpr int per = kIdx ? 1 : kPer;
  const int64_t k_tiles = (n + along - 1) / along;
  const int64_t r_tiles = (n_rays + kRays - 1) / kRays;
  const int64_t b = blockIdx.x;
  const int k0 =
      static_cast<int>(b % k_tiles) * along + per * static_cast<int>(threadIdx.x / kRays);
  const int r = static_cast<int>((b / k_tiles) % r_tiles) * kRays +
                static_cast<int>(threadIdx.x % kRays);
  const int64_t p = b / (k_tiles * r_tiles);
  if (r >= n_rays || k0 >= n) return;
  const S* s = src + 3 * p;
  const D* dv = dirs + p * dir_pose_stride + 3 * static_cast<int64_t>(r);
  const int64_t at = (p * n_rays + r) * n + k0;
  int x, y, z;
  if constexpr (kIdx) {
    __stcs(out + at, __ldg(vol + voxel(s, dv, k0, step, d, h, w, x, y, z)));
    __stcs(idx + 3 * at, x);
    __stcs(idx + 3 * at + 1, y);
    __stcs(idx + 3 * at + 2, z);
  } else {
    int64_t off[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      off[j] = k0 + j < n ? voxel(s, dv, k0 + j, step, d, h, w, x, y, z) : 0;
    T v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = __ldg(vol + off[j]);
    if (vec) {
      store4(out + at, v);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (k0 + j < n) __stcs(out + at + j, v[j]);
    }
  }
}

template <typename T, typename S, typename D, bool kIdx>
int launch_as(const void* vol, const void* src, const void* dirs, int64_t dir_pose_stride,
              void* out, int32_t* idx, int64_t p, int n_rays, int n, double step, int d, int h,
              int w, cudaStream_t stream) {
  constexpr int along = kIdx ? kAlong : kAlongValues;
  const int64_t blocks = p * ((n_rays + kRays - 1) / kRays) * ((n + along - 1) / along);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = n % kPer == 0 && reinterpret_cast<uintptr_t>(out) % (kPer * sizeof(T)) == 0;
  nearest_march_kernel<T, S, D, kIdx><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(vol), static_cast<const S*>(src), static_cast<const D*>(dirs),
      dir_pose_stride, static_cast<T*>(out), idx, n_rays, n, static_cast<D>(step), d, h, w, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S, typename D>
int launch(const void* vol, const void* src, const void* dirs, int64_t dir_pose_stride,
           void* out, int32_t* idx, int64_t p, int n_rays, int n, double step, int d, int h,
           int w, cudaStream_t stream) {
  return idx != nullptr
             ? launch_as<T, S, D, true>(vol, src, dirs, dir_pose_stride, out, idx, p, n_rays, n,
                                        step, d, h, w, stream)
             : launch_as<T, S, D, false>(vol, src, dirs, dir_pose_stride, out, idx, p, n_rays,
                                         n, step, d, h, w, stream);
}

template <typename T>
int by_points(int src_bytes, int dir_bytes, const void* vol, const void* src, const void* dirs,
              int64_t dir_pose_stride, void* out, int32_t* idx, int64_t p, int n_rays, int n,
              double step, int d, int h, int w, cudaStream_t stream) {
  if (src_bytes == 4 && dir_bytes == 4)
    return launch<T, float, float>(vol, src, dirs, dir_pose_stride, out, idx, p, n_rays, n,
                                   step, d, h, w, stream);
  if (src_bytes == 8 && dir_bytes == 8)
    return launch<T, double, double>(vol, src, dirs, dir_pose_stride, out, idx, p, n_rays, n,
                                     step, d, h, w, stream);
  if (src_bytes == 4 && dir_bytes == 8)
    return launch<T, float, double>(vol, src, dirs, dir_pose_stride, out, idx, p, n_rays, n,
                                    step, d, h, w, stream);
  if (src_bytes == 8 && dir_bytes == 4)
    return launch<T, double, float>(vol, src, dirs, dir_pose_stride, out, idx, p, n_rays, n,
                                    step, d, h, w, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// vol: (d, h, w) contiguous, elements of vol_bytes (2, 4 or 8); src: (p, 3)
// contiguous, floats of src_bytes (4 or 8); dirs: rays of 3 floats of
// dir_bytes, ray r of pose q at dirs + q * dir_pose_stride + 3 r (stride 0:
// one fan for every pose); out: (p, n_rays, n) elements of vol_bytes; idx:
// (p, n_rays, n, 3) int32, or null for no idx; step in the directions' type.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for a width it does not take).
extern "C" int diffus_nearest_march(const void* vol, int vol_bytes, const void* src,
                                    int src_bytes, const void* dirs, int dir_bytes,
                                    int64_t dir_pose_stride, void* out, int32_t* idx, int64_t p,
                                    int n_rays, int n, double step, int d, int h, int w,
                                    void* stream) {
  if (p == 0 || n_rays == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (vol_bytes) {
    case 2:
      return by_points<uint16_t>(src_bytes, dir_bytes, vol, src, dirs, dir_pose_stride, out,
                                 idx, p, n_rays, n, step, d, h, w, st);
    case 4:
      return by_points<uint32_t>(src_bytes, dir_bytes, vol, src, dirs, dir_pose_stride, out,
                                 idx, p, n_rays, n, step, d, h, w, st);
    case 8:
      return by_points<unsigned long long>(src_bytes, dir_bytes, vol, src, dirs,
                                           dir_pose_stride, out, idx, p, n_rays, n, step, d, h,
                                           w, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
