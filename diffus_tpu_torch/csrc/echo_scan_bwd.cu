// The echo scan's backward (kernel K1b): dr for the gradient of the attenuated
// echo trace, as a block-cooperative chunked scan run forwards, then backwards.
//
// Replaces the VJP of the Pallas TPU kernel's custom_vjp,
// diffus_tpu/kernels/propagation_pallas.py (_bwd, :145-148), which runs
// jax.vjp through the XLA scan (_echo_jnp_from_r).  Its plain PyTorch twin,
// in this kernel's order, is echo_backward_plain
// (diffus_tpu_torch/kernels/propagation_cuda.py), whose docstring derives it:
// with P_i = s_i M_i P_{i-1} the carries, each scaled by s_i, and G_i the
// cotangent of P_i from echo i, the carries' cotangents run the reverse
// affine recurrence
//
//   A_N = G_N,   A_{i-1} = G_{i-1} + s_i M_i^T A_i,
//
// and dr_{i-1} = s_i <A_i, (dM_i/dr) P_{i-1}>.  (Every echo is homogeneous of
// degree 0 in a carry, so any positive s_i gives the same VJP in exact
// arithmetic.)
//
// Precision: every step runs in double, from the f32 r and grad and the
// factors exp(-att j) of depth_attenuation (in double), and dr is rounded to
// f32 once.  Near a resonance (d ~ 0) the echo's derivatives amplify the
// carries' rounding: with f32 carries in a chunked order the gradient sat
// ~10x further from float64 autograd than f32 autograd through the plain scan
// does (rendered phantom reflections, 511 interfaces); in double it sits ~10x
// nearer.  The forward's f32 table of repeated multiplications is not used:
// it drifts from exp(-att j) by up to ~3e-5 relative at depth 511.
//
// What bounds it on the card: neither bytes nor operations but the length of
// one thread's chain of dependent f64 steps, times the waves of blocks.  The
// bytes, r and grad read once and dr written once, are 12 B an interface
// (12.6 MB at 8 x 256 rays x 511, 3.8 us at 3.35 TB/s); the VJP's ~70
// operations an interface (the forward step and the reverse one) are 2.2 us
// at the 34 TFLOP/s of f64.
//
// Design: one block of kThreads threads (2 to 32 warps) a ray, thread l
// owning the contiguous chunk of interfaces [l c, (l+1) c), c = ceil(n /
// kThreads) <= kC, so a chain holds c <= 8 steps a pass.  The wrapper takes
// the fewest threads that keep c <= 8: 64 (two warps) up to 512 interfaces.
//  - Staging: every load of a thread's share of the row (r, and grad times
//    exp(-att j) in double) is issued before the first is used, coalesced,
//    then stored chunk-major to shared memory (odd stride: no bank
//    conflicts); the att table is read once a block.
//  - The carries are recomputed from r, not stored by the forward.  Pass 1
//    forms each chunk's product; a two-level scan (5 __shfl_up_sync rounds
//    inside each warp, then the warps' totals scanned by warp 0 through
//    shared memory) gives each chunk's carry in.
//  - The replay from the carry keeps each step's carry in (shared memory),
//    its scale and the echo's cotangent (c, d) (registers: kC is a template
//    parameter, so the arrays are registers) and folds the chunk into the
//    affine map Y -> T Y + h that takes the cotangent entering its last
//    step to the one leaving its first.
//  - A two-level suffix scan of the maps (__shfl_down_sync in the warp, the
//    warps' totals by warp 0) gives each thread the cotangent entering its
//    chunk; it walks the chunk backwards from it, writes dr into the slot its
//    r came from, and the block stores the row with coalesced stores.
//  - Renormalization without division: a carry is scaled by 2^-e, e read from
//    the exponent bits of its max-abs entry (floored at 2^-100).  Scaling by
//    a power of two rounds nothing, and the chain holds no f64 division; the
//    only one left, the echo's 1/d (for c/d and g/d), is off the carry chain
//    and runs once an interface.
// The time is the waves of blocks times a block's chain, and residency is
// set by registers: a first draft that kept the carries in registers too
// took 192 registers a thread at 64 threads and c = 8 (10 warps an SM) and
// 25.7 us at 2048 x 511; with them in shared memory 124 (16 warps an SM)
// and 16.9 us (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py --backward).
// Shared memory: 12 B an interface slot (r as f32, grad * att as f64), 32 B
// a step of a chunk (its carry in) and 128 B a warp for the scans' totals:
// 23.6 KB at N = 511 and 64 threads (stride 9); 1024 threads keep the
// carries in registers instead (spilling).
//
// Numerics: built with --fmad=false and IEEE division, every operation in the
// twin's order, in double as the twin, so kernel == twin bit for bit.  The
// scale is NaN if an entry of the carry is NaN (as the forward's NaN-
// propagating max makes it) and 0 if the largest entry is infinite.  The
// echo's cotangent follows autograd through nan_to_num(-(c/d)): zero where
// c/d is not finite, and the division's backward forms 0 (1/0) = NaN at d' =
// 0 and NaN on a NaN carry, so a NaN interface or a d' = 0 echo makes its
// ray's whole dr NaN, as jax.grad through echo_pallas does.  The padding
// (r = 0, grad 0) adds no cotangent.

#include "echo_scan_common.cuh"

namespace {

using DMat = Mat<double>;

// The affine map Y -> T Y + h of 2x2 matrices.
struct Map {
  DMat t, h;
};

constexpr int kFloorHi = 0x39B00000;  // the high word of 2^-100, the scale's floor
constexpr int kInfHi = 0x7ff00000;

__device__ __forceinline__ DMat shfl_down(const DMat& m, int delta) {
  return {__shfl_down_sync(kFullMask, m.a, delta), __shfl_down_sync(kFullMask, m.b, delta),
          __shfl_down_sync(kFullMask, m.c, delta), __shfl_down_sync(kFullMask, m.d, delta)};
}

__device__ __forceinline__ DMat identity() { return {1.0, 0.0, 0.0, 1.0}; }
__device__ __forceinline__ DMat zero() { return {0.0, 0.0, 0.0, 0.0}; }

__device__ __forceinline__ int abs_hi(double v) { return __double2hiint(v) & 0x7fffffff; }

// 2^-e, with 2^(e-1) <= the max-abs entry < 2^e read from the entries' high
// words (sign off: ordered as the magnitudes, NaN above inf), the max floored
// at 2^-100; NaN if an entry is NaN, 0 if the largest is infinite.
__device__ __forceinline__ double pow2_scale(double a, double b, double c, double d) {
  const int top = max(max(max(abs_hi(a), abs_hi(b)), max(abs_hi(c), abs_hi(d))), kFloorHi);
  if (top >= kInfHi) return top > kInfHi ? __longlong_as_double(0x7ff8000000000000LL) : 0.0;
  return __hiloint2double((2045 - (top >> 20)) << 20, 0);
}

__device__ __forceinline__ DMat scaled(double a, double b, double c, double d, double& s) {
  s = pow2_scale(a, b, c, d);
  return {a * s, b * s, c * s, d * s};
}

// The later product q left-multiplies the earlier p, scaled.
__device__ __forceinline__ DMat combine2(const DMat& p, const DMat& q) {
  double s;
  return scaled(q.a * p.a + q.b * p.c, q.a * p.b + q.b * p.d, q.c * p.a + q.d * p.c,
                q.c * p.b + q.d * p.d, s);
}

// One interface [[k, x], [m10, 1]] left-multiplies the carry p; s its scale.
template <bool kParity>
__device__ __forceinline__ DMat step2(const DMat& p, double x, double& s) {
  const double k = kParity ? 1.0 - 2.0 * x * x : 1.0;
  const double m10 = kParity ? -x : x;
  return scaled(k * p.a + x * p.c, k * p.b + x * p.d, m10 * p.a + 1.0 * p.c,
                m10 * p.b + 1.0 * p.d, s);
}

// The h of the map s after o, when o's is oh: T_s oh + h_s.
__device__ __forceinline__ DMat apply(const DMat& t, const DMat& h, const DMat& oh) {
  return {t.a * oh.a + t.b * oh.c + h.a, t.a * oh.b + t.b * oh.d + h.b,
          t.c * oh.a + t.d * oh.c + h.c, t.c * oh.b + t.d * oh.d + h.d};
}

__device__ __forceinline__ DMat matmul(const DMat& t, const DMat& o) {
  return {t.a * o.a + t.b * o.c, t.a * o.b + t.b * o.d, t.c * o.a + t.d * o.c,
          t.c * o.b + t.d * o.d};
}

// The echo's cotangent on the carry's (c, d): g the echo's gradient times its
// attenuation factor; zero on the padding (real false).  One division: q =
// c (1/d), t = g (1/d).
__device__ __forceinline__ void echo_cotangent(const DMat& p, double g, bool real, double& gc,
                                               double& gd) {
  if (!real) {
    gc = 0.0;
    gd = 0.0;
    return;
  }
  const double rd = 1.0 / p.d;
  const double q = p.c * rd;
  const double t = (isfinite(q) ? g : 0.0) * rd;
  gc = -t;
  gd = t * q;
}

// Interface j of the row and its slot (j / c, j % c) in the chunks, kept as j
// steps by kThreads with no division per step.
template <int kThreads>
struct Slot {
  int jc, ji;
  const int c, dq, dm;
  __device__ Slot(int j, int c_)
      : jc(j / c_), ji(j % c_), c(c_), dq(kThreads / c_), dm(kThreads % c_) {}
  __device__ int at(int stride) const { return jc * stride + ji; }
  __device__ void advance() {
    jc += dq;
    ji += dm;
    if (ji >= c) {
      ji -= c;
      ++jc;
    }
  }
};

// r: (b, n) f32; grad: (b, n + 1) f32; att: (n + 1,) double; dr: (b, n) f32.
// One block a ray; c <= kC interfaces a thread.  Shared: grad * att's chunks
// (double, thread l's at l * stride), the scans' totals, each step's carry in
// (double, step-major, thread-minor: no bank conflicts), then r's chunks
// (f32, then dr's).
// Whether a block's carries in (32 B a step of each thread's chunk) live in
// shared memory: 1024 threads would need 256 KB at kC = 8, more than an SM
// has, and keep them in registers (spilling).
template <int kThreads, int kC>
constexpr bool kCarriesShared = 32 * kC * kThreads <= 128 * 1024;

template <bool kParity, int kThreads, int kC>
__global__ void __launch_bounds__(kThreads)
echo_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ grad,
                     const double* __restrict__ att, float* __restrict__ dr, int n, int c,
                     int stride) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ double dsmem[];
  double* const gs = dsmem;
  DMat* const carry_tot = reinterpret_cast<DMat*>(gs + kThreads * stride);
  Map* const map_tot = reinterpret_cast<Map*>(carry_tot + kWarps);
  DMat* const next_h = reinterpret_cast<DMat*>(map_tot + kWarps);
  constexpr bool kShared = kCarriesShared<kThreads, kC>;
  double* const qs = reinterpret_cast<double*>(next_h + kWarps + 1);
  float* const xs = reinterpret_cast<float*>(qs + (kShared ? kC * 4 * kThreads : 0));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* const src = r + static_cast<int64_t>(blockIdx.x) * n;
  const float* const gsrc = grad + static_cast<int64_t>(blockIdx.x) * (n + 1);

  {  // staging: every load in flight, then chunk-major stores
    float xv[kC], gv[kC];
    double av[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int j = tid + i * kThreads;
      const bool in = i < c && j < n;
      xv[i] = in ? __ldg(src + j) : 0.0f;
      gv[i] = in ? __ldg(gsrc + j + 1) : 0.0f;
      av[i] = in ? __ldg(att + j + 1) : 0.0;
    }
    Slot<kThreads> pos(tid, c);
#pragma unroll
    for (int i = 0; i < kC; ++i, pos.advance()) {
      if (i < c) {
        xs[pos.at(stride)] = xv[i];
        gs[pos.at(stride)] = static_cast<double>(gv[i]) * av[i];
      }
    }
  }
  __syncthreads();
  float* const chunk = xs + tid * stride;
  const double* const gchunk = gs + tid * stride;
  const int j0 = tid * c;  // this chunk's first interface in its ray
  float x[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) x[i] = i < c ? chunk[i] : 0.0f;

  // pass 1 and the two-level scan over the block's chunks: the carry in
  DMat q = identity();
  double s;
#pragma unroll
  for (int i = 0; i < kC; ++i)
    if (i < c) q = step2<kParity>(q, x[i], s);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const DMat p = shfl_up<32>(q, o);
    if (lane >= o) q = combine2(p, q);
  }
  if (lane == 31) carry_tot[warp] = q;
  __syncthreads();
  if (warp == 0) {
    DMat v = lane < kWarps ? carry_tot[lane] : identity();
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const DMat p = shfl_up<32>(v, o);
      if (lane >= o) v = combine2(p, v);
    }
    if (lane < kWarps) carry_tot[lane] = v;
  }
  __syncthreads();
  const DMat before = warp > 0 ? carry_tot[warp - 1] : identity();
  const DMat prev = shfl_up<32>(q, 1);
  DMat p = lane > 0 ? combine2(before, prev) : before;

  // replay: keep each step's carry in (shared), scale and cotangent
  // (registers); fold the chunk into (T, h)
  double* const q0 = qs + tid;  // step i's entry f at q0[(4 i + f) kThreads]
  DMat q0r[kC];                 // the carries in where shared memory cannot hold them
  double sc[kC], gcs[kC], gds[kC];
  DMat t = identity(), h = zero();
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    if (i < c) {
      if constexpr (kShared) {
        q0[(4 * i) * kThreads] = p.a;
        q0[(4 * i + 1) * kThreads] = p.b;
        q0[(4 * i + 2) * kThreads] = p.c;
        q0[(4 * i + 3) * kThreads] = p.d;
      } else {
        q0r[i] = p;
      }
      const double xi = x[i];
      const double k = kParity ? 1.0 - 2.0 * xi * xi : 1.0;
      const double m10 = kParity ? -xi : xi;
      p = step2<kParity>(p, xi, sc[i]);
      const double si = sc[i];
      t = {(t.a * k + t.b * xi) * si, (t.a * m10 + t.b) * si, (t.c * k + t.d * xi) * si,
           (t.c * m10 + t.d) * si};
      echo_cotangent(p, gchunk[i], j0 + i < n, gcs[i], gds[i]);
      h = {h.a + t.b * gcs[i], h.b + t.b * gds[i], h.c + t.d * gcs[i], h.d + t.d * gds[i]};
    }
  }

  // the two-level inclusive suffix scan of the maps, shifted by one chunk
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const DMat to = shfl_down(t, o), ho = shfl_down(h, o);
    if (lane + o < 32) {
      h = apply(t, h, ho);
      t = matmul(t, to);
    }
  }
  if (lane == 0) map_tot[warp] = {t, h};
  __syncthreads();
  if (warp == 0) {
    Map v = lane < kWarps ? map_tot[lane] : Map{identity(), zero()};
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const DMat to = shfl_down(v.t, o), ho = shfl_down(v.h, o);
      if (lane + o < kWarps) {
        v.h = apply(v.t, v.h, ho);
        v.t = matmul(v.t, to);
      }
    }
    if (lane < kWarps) next_h[lane] = v.h;
    if (lane == 0) next_h[kWarps] = zero();
  }
  __syncthreads();
  const DMat hu = next_h[warp + 1];  // the cotangent entering the next warp's chunks
  const DMat tn = shfl_down(t, 1), hn = shfl_down(h, 1);
  DMat bt = lane < 31 ? apply(tn, hn, hu) : hu;

  // walk the chunk backwards
#pragma unroll
  for (int i = kC - 1; i >= 0; --i) {
    if (i < c) {
      DMat q0i;  // the carry before step i
      if constexpr (kShared) {
        q0i = {q0[(4 * i) * kThreads], q0[(4 * i + 1) * kThreads], q0[(4 * i + 2) * kThreads],
               q0[(4 * i + 3) * kThreads]};
      } else {
        q0i = q0r[i];
      }
      const double si = sc[i], xi = x[i];
      const DMat a = {bt.a, bt.b, bt.c + gcs[i], bt.d + gds[i]};
      double k, m10, dr_i;
      if (kParity) {
        const double m4 = -4.0 * xi;
        k = 1.0 - 2.0 * xi * xi;
        m10 = -xi;
        dr_i = a.a * (m4 * q0i.a + q0i.c) + a.b * (m4 * q0i.b + q0i.d) + a.c * (-q0i.a) +
               a.d * (-q0i.b);
      } else {
        k = 1.0;
        m10 = xi;
        dr_i = a.a * q0i.c + a.b * q0i.d + a.c * q0i.a + a.d * q0i.b;
      }
      chunk[i] = __double2float_rn(dr_i * si);  // the slot of r_j now holds dr_j
      bt = {(k * a.a + m10 * a.c) * si, (k * a.b + m10 * a.d) * si, (xi * a.a + a.c) * si,
            (xi * a.b + a.d) * si};
    }
  }

  __syncthreads();
  float* const dst = dr + static_cast<int64_t>(blockIdx.x) * n;
  Slot<kThreads> pos(tid, c);
#pragma unroll
  for (int i = 0; i < kC; ++i, pos.advance()) {
    const int j = tid + i * kThreads;
    if (i < c && j < n) dst[j] = xs[pos.at(stride)];
  }
}

template <bool kParity, int kThreads, int kC>
cudaError_t launch(const float* r, const float* grad, const double* att, float* dr, int n,
                   int64_t b, cudaStream_t stream) {
  constexpr int kWarps = kThreads / 32;
  const int c = (n + kThreads - 1) / kThreads;
  const int stride = c | 1;  // odd: threads reading word i of their chunks hit distinct banks
  const size_t smem = 12 * static_cast<size_t>(kThreads) * stride +
                      sizeof(DMat) * kWarps + sizeof(Map) * kWarps + sizeof(DMat) * (kWarps + 1) +
                      (kCarriesShared<kThreads, kC> ? sizeof(DMat) * kC * kThreads : 0);
  auto kernel = echo_scan_bwd_kernel<kParity, kThreads, kC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch's check must not see it
      return e;
    }
  }
  if (b > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(b), kThreads, smem, stream>>>(r, grad, att, dr, n, c, stride);
  return cudaGetLastError();
}

// The instance whose chunk holds ceil(n / kThreads) interfaces: kC 4 where
// that is enough (fewer registers), else 8; 256 threads and more serve rays
// deeper than 128 x 8 only, with kC 8.
template <bool kParity, int kThreads>
cudaError_t launch_chunk(const float* r, const float* grad, const double* att, float* dr, int n,
                         int64_t b, cudaStream_t stream) {
  const int c = (n + kThreads - 1) / kThreads;
  if constexpr (kThreads <= 128) {
    if (c <= 4) return launch<kParity, kThreads, 4>(r, grad, att, dr, n, b, stream);
  }
  if (c <= 8) return launch<kParity, kThreads, 8>(r, grad, att, dr, n, b, stream);
  return cudaErrorInvalidValue;
}

template <bool kParity>
cudaError_t launch_threads(int threads, const float* r, const float* grad, const double* att,
                           float* dr, int n, int64_t b, cudaStream_t stream) {
  switch (threads) {
    case 64:
      return launch_chunk<kParity, 64>(r, grad, att, dr, n, b, stream);
    case 128:
      return launch_chunk<kParity, 128>(r, grad, att, dr, n, b, stream);
    case 256:
      return launch_chunk<kParity, 256>(r, grad, att, dr, n, b, stream);
    case 512:
      return launch_chunk<kParity, 512>(r, grad, att, dr, n, b, stream);
    case 1024:
      return launch_chunk<kParity, 1024>(r, grad, att, dr, n, b, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r: (b, n) f32 ray-major; grad: (b, n + 1) f32, the gradient of the echo
// trace; att: (n + 1,) double, exp(-att j); dr: (b, n) f32.  mode 0 = parity,
// 1 = symmetric; threads 64, 128, 256, 512 or 1024 per ray, with at most 8
// interfaces a thread.  Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for a mode, a thread count or a depth it is not
// built for), as diffus_echo_scan does.
extern "C" int diffus_echo_scan_bwd(const float* r, const float* grad, const double* att,
                                    float* dr, int n, int64_t b, int mode, int threads,
                                    void* stream) {
  if (b == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return static_cast<int>(launch_threads<true>(threads, r, grad, att, dr, n, b, s));
  if (mode == 1)
    return static_cast<int>(launch_threads<false>(threads, r, grad, att, dr, n, b, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
