// The ultrasound artifact stack in one kernel (K4): per frame of n_rays x
// n_samples float32 (or float64), the speckle product, the depth-dependent
// lateral blur and the unsharp mask, from the echo frame and the frame's
// two normal draws, writing only the finished frame.
//
// Replaces no Pallas kernel: the JAX package runs the stack as XLA ops
// (diffus_tpu/ops/artifacts.py speckle_arcs :26-52,
// depth_dependent_lateral_blur :55-92, sharpen :95-101), and so did the
// port's plain chain (ops/artifacts.py), some 60 elementwise passes a call
// with a (frames, n_rays, n_samples, 2R+1) intermediate in the lateral blur.
// Per frame it computes what these compute:
//
//   S = max(echo * (1 + sr_z radial_z) * (1 + sl_z local), 0)     speckle
//   L[r, z] = sum_k bank[z, k] S[pidx[r + k], z],  k = 0 .. 2R      lateral
//   B = the 9-tap Gaussian (sigma 1) of L over rays, then depths,
//       each with a symmetric ("reflect") pad                        sharpen
//   out = min(max(L + alpha (L - B), min L), max L)  (frame's min, max)
//
// The tables are the plain chain's own: sr_z, sl_z (ops/artifacts.py
// _speckle_scales), the tap bank and its symmetric-pad ray index
// (_lateral_bank), the sharpen's taps (gaussian_kernel1d(1.0, 4)) and its
// reflect indices (filters.py _reflect_index), so the edges are the same,
// numpy's repeated reflections of short frames included.
//
// Numerics.  The speckle product and the sharpen's shift-adds run the plain
// chain's f32 operations in its order (the build has --fmad=false), and the
// clamp, the clip and the frame's min and max propagate NaN as torch's
// clamp_min, maximum, minimum, amin and amax do.  The lateral blur's 2R+1
// products are summed in tap order by fmaf from 0: torch's sum reduces the
// 33 products of its view in another order, so frames with R > 0 differ from
// the plain chain by a few ulps before the sharpen (which amplifies them by
// up to 1 + 2 alpha); with R = 0 (no lateral blur) the kernel equals the
// plain chain bit for bit.  Every sum has a fixed order and no atomics, so
// a launch repeats bit for bit.
//
// A float64 frame runs the same code with T = double: the plain chain's
// operations in double, in the same order, so the kernel serves a float64
// render on the card as it serves a float32 one.  A pixel takes twice the
// shared memory, so the lung view's frame (200 x 80) takes the depth tiles.
//
// What bounds it on the card: bytes.  A frame reads the echo and the local
// normals and writes the frame once, 3 x 4 B a pixel (the radial normals
// are one row): at the lung view (200 x 80) 192 KB a frame, 49 MB for 256
// frames, 15 us at 3.35 TB/s.  Its arithmetic, 2R+1 multiply-adds a pixel
// in the lateral blur and 18 operations in the sharpen, is ~1 us at
// 67 TFLOP/s.  The plain chain moved ~1.2 GB a call for the same result.
//
// Design: one block of 512 threads a frame.  The speckled frame S and the
// lateral-blurred L live in shared memory (2 x 64 KB at the lung view), so
// nothing between the echo and the finished frame touches device memory.
// The lateral blur couples the rays of one depth within +-R, the sharpen
// +-4 on both axes, and its clip needs the whole frame's min and max of L:
//
//  - A frame that fits (2 n_rays n_samples floats and the tables within
//    227 KB) is one tile: the echo and the local normals copied into the
//    two buffers by cp.async (16-byte pieces where the rows allow), every
//    copy of the block in flight at once, S formed in place, L computed
//    into the second buffer with the frame's min and max, the ray pass of
//    the Gaussian written over S, then the depth pass, the sharpen and the
//    clip, each output written once.
//  - A larger frame is cut into depth tiles of TZ columns: a first sweep
//    stages S and L tile by tile for the min and max alone, a second
//    stages each tile again with 4 columns of halo a side, which the depth
//    pass reads, and finishes it.  The echo and normals are read twice; the
//    frame is still written once.
//
// The lateral blur is register-blocked: a thread owns 8 consecutive rays
// at one depth and slides a window of 15 staged values over the taps, 8
// taps at a time (taps in registers, transposed in shared memory so that
// a warp's lanes, consecutive depths, read consecutive words), so a tap
// costs one multiply-add and ~1/3 of a shared load.  The ray pass of the
// Gaussian is blocked the same way; the depth pass reads its 9 columns
// through the reflect index, and computes every ray of its block in one
// straight run (a ray past the frame on the last one, not stored) so that
// the sums interleave.  Lanes run along depth, the rows' contiguous axis,
// so the loads and stores of device memory are coalesced.
//
// What holds it from the bound: a block's 141 KB of shared memory at the
// lung view (float32) leaves one block an SM, so its copies in, its arithmetic and
// its stores run one after another and no other block overlaps them (256
// frames are two waves on 132 SMs).  Row padding against bank conflicts,
// 1024 or 256 threads, 4 or 16 rays a thread and plain stores were timed
// and lost or tied (PERF.md).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRays = 8;       // consecutive rays a thread blurs at one depth
constexpr int kTapChunk = 8;   // lateral taps held in registers at a time
constexpr int kBatch = 4;      // staged pixels a thread loads before it computes them
constexpr int kPadRows = kRays + kTapChunk;   // pad-index entries past the window (row 0)
constexpr int kHalf = 4;       // the sharpen's radius: gaussian_kernel1d(1.0, 4)
constexpr int kTaps = 2 * kHalf + 1;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use on sm_90

// Offsets, in elements of the frame's type T, of the block's shared
// arrays: for the host's plan and the kernel alike.  Rows of the two frame
// buffers are w elements; an int of an index array takes an element.
struct Layout {
  int a, b, bank, radf, slz, red, pw, qw, zl, words;
  __host__ __device__ Layout(int nr, int k, int w, int tz) {
    a = 0;
    b = a + nr * w;
    bank = b + nr * w;                 // (k, w): taps transposed, depth fastest
    radf = bank + k * w;               // 1 + sr_z radial_z, per staged column
    slz = radf + w;                    // sl_z, per staged column
    red = slz + w;                     // the warps' min and max
    pw = red + 2 * kWarps;             // lateral pad index (nr + 2R, then row 0) times w
    qw = pw + nr + (k > 0 ? k - 1 : 0) + kPadRows;   // the sharpen's ray reflect index (nr + 8,
                                                     // then row 0) times w
    zl = qw + nr + 2 * kHalf + kRays;  // the sharpen's depth index (tz + 8), tile-local
    words = zl + tz + 2 * kHalf;
  }
  size_t bytes(size_t elem) const { return elem * static_cast<size_t>(words); }
};

__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// torch's NaN rules: maximum / minimum / amax / amin propagate NaN
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return a != a ? a : (b != b ? b : max_(a, b));
}
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return a != a ? a : (b != b ? b : min_(a, b));
}

// one element (4 or 8 bytes) from device memory to shared memory,
// asynchronously (cp.async)
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// 16 bytes likewise, both addresses 16-byte aligned
template <typename T>
__device__ __forceinline__ void copy_async16(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// this thread's copies have landed (other threads' after a __syncthreads)
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

template <typename T>
struct Args {
  const T* echo;            // (frames, nr, ns)
  const T* radial;          // (frames, ns)
  const T* local;           // (frames, nr, ns)
  const T* sr;              // (ns,)
  const T* sl;              // (ns,)
  const T* bank;            // (ns, k); unused when k = 0
  const int64_t* pidx;      // (nr + k - 1,); unused when k = 0
  const int64_t* qidx;      // (nr + 8,)
  const int64_t* zidx;      // (ns + 8,)
  const T* taps;            // (9,)
  T* out;                   // (frames, nr, ns)
  T alpha;
  int nr, ns, k, tz, w;
};

template <typename T>
struct Block {
  static constexpr int kVec = 16 / sizeof(T);   // elements of a 16-byte copy

  const Args<T>& a;
  const Layout lay;
  T* s;
  int64_t frame;

  __device__ T* at(int off) const { return s + off; }
  __device__ int* iat(int off) const { return reinterpret_cast<int*>(s + off); }

  // S of columns [c0, c0 + wd) into `dst` (buffer a, or b when there is no
  // lateral blur, whose min and max are then taken here): the echo copied
  // into `dst` and the local normals into the other buffer, every copy in
  // flight at once, then the product in place
  __device__ void stage(int c0, int wd, T* dst, bool minmax, T& lo, T& hi) const {
    const int t = threadIdx.x;
    const T* rad = a.radial + frame * a.ns;
    for (int c = t; c < wd; c += kThreads) {
      const int z = c0 + c;
      at(lay.radf)[c] = T(1) + a.sr[z] * __ldg(rad + z);
      at(lay.slz)[c] = a.sl[z];
    }
    for (int i = t; i < a.k * wd; i += kThreads) {
      const int k = i / wd;
      const int c = i - k * wd;
      at(lay.bank)[k * a.w + c] = __ldg(a.bank + static_cast<int64_t>(c0 + c) * a.k + k);
    }
    T* noise = dst == at(lay.a) ? at(lay.b) : at(lay.a);
    const int64_t base = frame * a.nr * a.ns + c0;
    const int n = a.nr * wd;
    const uintptr_t bases =
        reinterpret_cast<uintptr_t>(a.echo) | reinterpret_cast<uintptr_t>(a.local);
    if (bases % 16 == 0 && (a.ns | a.w | c0 | wd) % kVec == 0) {   // rows of 16-byte pieces
      const int wdv = wd / kVec;
      for (int i = t; i < n / kVec; i += kThreads) {
        const int r = i / wdv;
        const int c = (i - r * wdv) * kVec;
        const int64_t g = base + static_cast<int64_t>(r) * a.ns + c;
        copy_async16(dst + r * a.w + c, a.echo + g);
        copy_async16(noise + r * a.w + c, a.local + g);
      }
    } else {
      for (int i = t; i < n; i += kThreads) {
        const int r = i / wd;
        const int c = i - r * wd;
        const int64_t g = base + static_cast<int64_t>(r) * a.ns + c;
        copy_async(dst + r * a.w + c, a.echo + g);
        copy_async(noise + r * a.w + c, a.local + g);
      }
    }
    wait_copies();
    __syncthreads();
    for (int i0 = t; i0 < n; i0 += kBatch * kThreads) {
      int at_row[kBatch];
      T e[kBatch], l[kBatch], rf[kBatch], sz[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n) {
          const int r = i / wd;
          const int c = i - r * wd;
          at_row[u] = r * a.w + c;
          e[u] = dst[at_row[u]];
          l[u] = noise[at_row[u]];
          rf[u] = at(lay.radf)[c];
          sz[u] = at(lay.slz)[c];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (i0 + u * kThreads < n) {
          T v = e[u] * rf[u];
          v = v * (T(1) + sz[u] * l[u]);
          v = v != v ? v : max_(v, T(0));           // torch.clamp_min
          dst[at_row[u]] = v;
          if (minmax) {
            lo = min_nan(lo, v);
            hi = max_nan(hi, v);
          }
        }
      }
    }
  }

  // L = the lateral blur of buffer a into buffer b, over wd columns
  __device__ void lateral(int wd, bool minmax, T& lo, T& hi) const {
    const T* src = at(lay.a);
    T* dst = at(lay.b);
    const T* bank = at(lay.bank);
    const int* pw = iat(lay.pw);
    const int items = (a.nr + kRays - 1) / kRays * wd;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int rb = it / wd;
      const int c = it - rb * wd;
      const int r0 = rb * kRays;
      const T* col = src + c;
      // x[i] = S at padded ray r0 + kc + i (past the window: row 0, whose
      // products are skipped or land on rays past the frame)
      T acc[kRays], x[kRays + kTapChunk - 1];
#pragma unroll
      for (int t = 0; t < kRays; ++t) acc[t] = T(0);
#pragma unroll
      for (int i = 0; i < kRays - 1; ++i) x[kTapChunk + i] = col[pw[r0 + i]];
      // taps kc .. kc + 7; `tail`: those past 2R skipped
      auto chunk = [&](int kc, bool tail) {
#pragma unroll
        for (int i = 0; i < kRays - 1; ++i) x[i] = x[kTapChunk + i];
        T w[kTapChunk];
#pragma unroll
        for (int i = 0; i < kTapChunk; ++i) {
          x[kRays - 1 + i] = col[pw[r0 + kc + kRays - 1 + i]];
          w[i] = !tail || kc + i < a.k ? bank[(kc + i) * a.w + c] : T(0);
        }
#pragma unroll
        for (int i = 0; i < kTapChunk; ++i) {
          if (!tail || kc + i < a.k) {
#pragma unroll
            for (int t = 0; t < kRays; ++t) acc[t] = fma_rn(w[i], x[t + i], acc[t]);
          }
        }
      };
      int kc = 0;
      for (; kc + kTapChunk <= a.k; kc += kTapChunk) chunk(kc, false);
      if (kc < a.k) chunk(kc, true);
#pragma unroll
      for (int t = 0; t < kRays; ++t) {
        if (r0 + t < a.nr) {
          dst[(r0 + t) * a.w + c] = acc[t];
          if (minmax) {
            lo = min_nan(lo, acc[t]);
            hi = max_nan(hi, acc[t]);
          }
        }
      }
    }
  }

  // the Gaussian's ray pass of buffer b into buffer a, over wd columns, in
  // correlate1d's order: g0 x0, then + g_j x_j in turn
  __device__ void ray_pass(int wd, const T (&g)[kTaps]) const {
    const T* src = at(lay.b);
    T* dst = at(lay.a);
    const int* qw = iat(lay.qw);
    const int items = (a.nr + kRays - 1) / kRays * wd;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int rb = it / wd;
      const int c = it - rb * wd;
      const int r0 = rb * kRays;
      T x[kRays + kTaps - 1];
#pragma unroll
      for (int i = 0; i < kRays + kTaps - 1; ++i) x[i] = src[qw[r0 + i] + c];   // past: row 0
      T v[kRays];
#pragma unroll
      for (int t = 0; t < kRays; ++t) {
        v[t] = g[0] * x[t];
#pragma unroll
        for (int j = 1; j < kTaps; ++j) v[t] = v[t] + g[j] * x[t + j];
      }
#pragma unroll
      for (int t = 0; t < kRays; ++t)
        if (r0 + t < a.nr) dst[(r0 + t) * a.w + c] = v[t];
    }
  }

  // the depth pass, the sharpen and the clip of output columns [z0, z1);
  // buffer a holds the ray pass and b holds L, both from column c0
  __device__ void finish(int z0, int z1, int c0, const T (&g)[kTaps], T lo, T hi) const {
    const T* blur = at(lay.a);
    const T* lat = at(lay.b);
    const int* zl = iat(lay.zl);
    const int wd = z1 - z0;
    T* out = a.out + frame * a.nr * a.ns + z0;
    const int items = (a.nr + kRays - 1) / kRays * wd;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int rb = it / wd;
      const int c = it - rb * wd;
      int zi[kTaps];
#pragma unroll
      for (int j = 0; j < kTaps; ++j) zi[j] = zl[c + j];
      const int lc = z0 - c0 + c;
      const int r0 = rb * kRays;
      // every ray of the block in one straight run (rays past the frame
      // computed on its last and not stored), so their sums interleave
      T v[kRays];
#pragma unroll
      for (int t = 0; t < kRays; ++t) {
        const int r = min(r0 + t, a.nr - 1);
        const T* row = blur + r * a.w;
        T b = g[0] * row[zi[0]];
#pragma unroll
        for (int j = 1; j < kTaps; ++j) b = b + g[j] * row[zi[j]];
        const T l = lat[r * a.w + lc];
        const T sharp = l + a.alpha * (l - b);
        v[t] = min_nan(max_nan(sharp, lo), hi);
      }
#pragma unroll
      for (int t = 0; t < kRays; ++t)
        if (r0 + t < a.nr) __stcs(out + static_cast<int64_t>(r0 + t) * a.ns + c, v[t]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
artifact_stack_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* const smem = reinterpret_cast<T*>(smem_bytes);
  const Block<T> blk{a, Layout(a.nr, a.k, a.w, a.tz), smem, static_cast<int64_t>(blockIdx.x)};
  const Layout& lay = blk.lay;
  const int t = threadIdx.x;
  int* pw = blk.iat(lay.pw);
  int* qw = blk.iat(lay.qw);
  if (a.k > 0)
    for (int p = t; p < a.nr + a.k - 1 + kPadRows; p += kThreads)
      pw[p] = p < a.nr + a.k - 1 ? static_cast<int>(a.pidx[p]) * a.w : 0;
  for (int p = t; p < a.nr + 2 * kHalf + kRays; p += kThreads)
    qw[p] = p < a.nr + 2 * kHalf ? static_cast<int>(a.qidx[p]) * a.w : 0;
  T g[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) g[j] = __ldg(a.taps + j);
  const bool blurred = a.k > 0;
  T* speckled = blk.at(blurred ? lay.a : lay.b);
  const int tiles = (a.ns + a.tz - 1) / a.tz;

  // sweep 1: L tile by tile, and the frame's min and max of it
  T lo = static_cast<T>(__int_as_float(0x7f800000)), hi = -lo;
  for (int tile = 0; tile < tiles; ++tile) {
    const int z0 = tile * a.tz;
    const int wd = min(a.ns, z0 + a.tz) - z0;
    blk.stage(z0, wd, speckled, !blurred, lo, hi);
    __syncthreads();
    if (blurred) blk.lateral(wd, true, lo, hi);
    __syncthreads();
  }
  T* red = blk.at(lay.red);
  for (int o = 16; o > 0; o /= 2) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (t % 32 == 0) {
    red[t / 32] = lo;
    red[kWarps + t / 32] = hi;
  }
  __syncthreads();
  for (int i = 0; i < kWarps; ++i) {
    lo = min_nan(lo, red[i]);
    hi = max_nan(hi, red[kWarps + i]);
  }

  // sweep 2: each tile with its halo (one tile: L is still in buffer b)
  int* zl = blk.iat(lay.zl);
  for (int tile = 0; tile < tiles; ++tile) {
    const int z0 = tile * a.tz;
    const int z1 = min(a.ns, z0 + a.tz);
    const int c0 = tiles > 1 ? max(0, z0 - kHalf) : 0;
    const int c1 = tiles > 1 ? min(a.ns, z1 + kHalf) : a.ns;
    if (tiles > 1) {
      T unused_lo, unused_hi;
      blk.stage(c0, c1 - c0, speckled, false, unused_lo, unused_hi);
      __syncthreads();
      if (blurred) blk.lateral(c1 - c0, false, unused_lo, unused_hi);
    }
    for (int j = t; j < z1 - z0 + 2 * kHalf; j += kThreads)
      zl[j] = static_cast<int>(a.zidx[z0 + j]) - c0;
    __syncthreads();
    blk.ray_pass(c1 - c0, g);
    __syncthreads();
    blk.finish(z0, z1, c0, g, lo, hi);
    __syncthreads();
  }
}

// echo, local, out: (frames, nr, ns) contiguous; radial: (frames, ns);
// sr, sl: (ns,); bank: (ns, k) and pidx: (nr + k - 1,) int64, or null with
// k = 0 (no lateral blur); qidx: (nr + 8,) and zidx: (ns + 8,) int64, the
// reflect indices; taps: (9,).  Plans the depth tiles, launches one block a
// frame on `stream` and returns the launch's error (cudaErrorInvalidValue
// for a frame no tile of shared memory can hold).
template <typename T>
int launch(const T* echo, const T* radial, const T* local, const T* sr, const T* sl,
           const T* bank, const int64_t* pidx, const int64_t* qidx, const int64_t* zidx,
           const T* taps, T* out, T alpha, int64_t frames, int nr, int ns, int k,
           void* stream) {
  if (frames < 1 || frames > 0x7fffffff || nr < 1 || ns < 1 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the whole frame in one tile if it fits, else the widest tile that does;
  // a tile's halo lies in the frame once ns > 2 kHalf (one reflection)
  constexpr size_t kElem = sizeof(T);
  int tz = ns, w = ns;
  if (Layout(nr, k, w, tz).bytes(kElem) > kMaxSmem) {
    const int per_col = 2 * nr + k + 2 + 1;   // two buffers, taps, radf, slz; zl
    const int fixed = Layout(nr, k, 0, 0).words + 2 * kHalf * per_col;
    tz = (kMaxSmem / static_cast<int>(kElem) - fixed) / per_col;
    w = tz + 2 * kHalf;
    if (tz < 1 || ns <= 2 * kHalf) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout lay(nr, k, w, tz);
  const size_t bytes = lay.bytes(kElem);
  if (bytes > kMaxSmem || static_cast<int64_t>(nr) * w > 0x7fffffff / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        artifact_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch's check must not see it
      return static_cast<int>(e);
    }
  }
  const Args<T> a{echo, radial, local, sr, sl, bank, pidx, qidx, zidx, taps, out, alpha,
                  nr, ns, k, tz, w};
  artifact_stack_kernel<T><<<static_cast<unsigned>(frames), kThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 frames and tables (see launch)
extern "C" int diffus_artifact_stack(const float* echo, const float* radial, const float* local,
                                     const float* sr, const float* sl, const float* bank,
                                     const int64_t* pidx, const int64_t* qidx,
                                     const int64_t* zidx, const float* taps, float* out,
                                     float alpha, int64_t frames, int nr, int ns, int k,
                                     void* stream) {
  return launch<float>(echo, radial, local, sr, sl, bank, pidx, qidx, zidx, taps, out, alpha,
                       frames, nr, ns, k, stream);
}

// float64 frames and tables (see launch)
extern "C" int diffus_artifact_stack_f64(const double* echo, const double* radial,
                                         const double* local, const double* sr,
                                         const double* sl, const double* bank,
                                         const int64_t* pidx, const int64_t* qidx,
                                         const int64_t* zidx, const double* taps, double* out,
                                         double alpha, int64_t frames, int nr, int ns, int k,
                                         void* stream) {
  return launch<double>(echo, radial, local, sr, sl, bank, pidx, qidx, zidx, taps, out, alpha,
                        frames, nr, ns, k, stream);
}
