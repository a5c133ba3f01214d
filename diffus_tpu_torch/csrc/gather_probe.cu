// Row-gather probe (kernel K3): the sum of n_rows 128-float rows of an
// (M, 128) f32 table at row ids (off + 97 i) mod M, i = 0 .. n_rows - 1.
//
// Replaces the Pallas TPU kernel diffus_tpu/kernels/gather_dma_probe.py
// (_probe_kernel, :43, launched by dma_gather_probe, :80-107).  On the TPU
// each row is fetched by its own scalar-issued DMA, n_buf deep, into VMEM,
// and one sequential loop sums them; the probe measures what a fused
// ray-march kernel would pay per gathered row.  Here threads load device
// memory directly, so the probe measures that instead.
//
// Schedule: the ids repeat with period P = M / gcd(97, M) in i (M, or M / 97
// when 97 divides M), so the walk visits D = min(P, n_rows) distinct rows:
// row id(j), j < D, comes up c_j = q + (j < r) times, where n_rows = q P + r.
// Work item j fetches row id(j) once and adds c_j times it.  The fetches stay
// random 512-byte rows 97 apart, one per distinct row; the repeats come from
// registers.  (Fetching every gathered row read each row of the probe's
// 64 MiB table, larger than L2, 8 times.)
//
// Design: one warp per 512-byte row, each lane one 16-byte float4 (the whole
// row is one coalesced 512-byte request).  Warp w of T in the grid takes
// j = w, w + T, w + 2T, ... and keeps NBUF (= n_buf) row loads in flight:
// the loads of NBUF rows are issued, unrolled, before any of them is added.
// A warp steps its row id by (97 T) mod M, so no division runs in the loop.
// Each block (16 warps, 2 an SM) sums its warps' registers through shared
// memory, by a fixed pairwise tree, into one row of a (G, 128) partials
// buffer; a second kernel sums the G partials of each column in a fixed
// order: that sum is one block's work, so fewer, larger blocks make it
// shorter.  The order of every sum depends only on the grid, so the result
// is deterministic and no atomics are needed.
//
// Row ids: the Pallas kernel computes off + 97 i in int32 and takes jnp's
// floor modulo, which is never negative.  C's % keeps the dividend's sign,
// so the first id is ((x % m) + m) % m, in 64 bits; the wrapper refuses
// inputs where off + 97 (n_rows - 1) leaves int32, so 64 bits give the
// same ids.
//
// What bounds it on the card: D x 512 bytes of random reads, each distinct
// row once (64 MiB at D = M = 131072, 20 us at 3.35 TB/s).  Rows 97 apart
// are not neighbours, so each read is its own transaction; the loads in
// flight per SM (warps x NBUF x 512 bytes) hide the latency.  The
// multiply-adds are negligible.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 32;          // 32 lanes x float4 = one 128-float row
constexpr int kWarpsPerBlock = 16;  // 2 blocks an SM (the wrapper's grid): 32 warps
constexpr int kThreads = kLanes * kWarpsPerBlock;
constexpr int kRowFloats = 128;
constexpr int kStride = 97;
constexpr int kSumGroups = 32;      // sum_partials_kernel: warps, each a strided share of rows

// The walk's distinct rows and how often each comes up: D = min(P, n_rows),
// and n_rows = q P + r, so row id(j), j < D, is summed q + (j < r) times.
struct Schedule {
  int64_t distinct, q, r;
};

Schedule schedule(int64_t n_rows, int m) {
  const int64_t period = m % kStride == 0 ? m / kStride : m;
  return {n_rows < period ? n_rows : period, n_rows / period, n_rows % period};
}

__device__ __forceinline__ uint32_t row_id(int64_t off, int64_t j, int64_t m) {
  return static_cast<uint32_t>((((off + kStride * j) % m) + m) % m);
}

// id < m and step < m <= 2^31 - 1, so the sum fits 32 unsigned bits
__device__ __forceinline__ uint32_t next_id(uint32_t id, uint32_t step, uint32_t m) {
  id += step;
  return id >= m ? id - m : id;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void add_times4(float4& a, float c, const float4& b) {
  a.x += c * b.x;
  a.y += c * b.y;
  a.z += c * b.z;
  a.w += c * b.w;
}

// sums[0][lane] = the sum of sums[0..N)[lane] by a fixed pairwise tree
// (N a power of two; warp w of the block holds sums[w]); ends synchronised
template <int N>
__device__ __forceinline__ void tree_sum(float4 (*sums)[kLanes], int warp, int lane) {
  __syncthreads();
#pragma unroll
  for (int half = N / 2; half > 0; half /= 2) {
    if (warp < half) add4(sums[warp][lane], sums[warp + half][lane]);
    __syncthreads();
  }
}

template <int NBUF>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table, float4* __restrict__ partial, int off,
                   int64_t distinct, int m, int64_t q, int64_t r) {
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int64_t total = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const uint32_t step = static_cast<uint32_t>(kStride * (total % m) % m);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int64_t j = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  uint32_t id = row_id(off, j, m);
  float4 acc = zero;
  for (; j < distinct; j += NBUF * total) {
    float4 v[NBUF];
    float c[NBUF];
#pragma unroll
    for (int k = 0; k < NBUF; ++k) {
      // the load is unconditional, so the NBUF loads issue back to back: past
      // the warp's last row `id` stays on it (a cache hit), and it adds zero
      const int64_t jk = j + k * total;
      const bool in = jk < distinct;
      const float4 x = __ldg(table + static_cast<int64_t>(id) * kLanes + lane);
      v[k] = in ? x : zero;
      c[k] = in ? static_cast<float>(q + (jk < r)) : 0.0f;
      if (jk + total < distinct) id = next_id(id, step, static_cast<uint32_t>(m));
    }
#pragma unroll
    for (int k = 0; k < NBUF; ++k) add_times4(acc, c[k], v[k]);
  }
  __shared__ float4 warp_sums[kWarpsPerBlock][kLanes];
  warp_sums[warp][lane] = acc;
  tree_sum<kWarpsPerBlock>(warp_sums, warp, lane);
  if (warp == 0) partial[static_cast<int64_t>(blockIdx.x) * kLanes + lane] = warp_sums[0][lane];
}

// out[c] = the sum over b < g of partial[b][c], in a fixed order: warp k sums
// rows b = k, k + kSumGroups, ... in turn, then the warps' sums are added by
// a fixed pairwise tree.
__global__ void __launch_bounds__(kSumGroups * kLanes)
sum_partials_kernel(const float4* __restrict__ partial, float4* __restrict__ out, int g) {
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int b = group; b < g; b += kSumGroups)
    add4(s, partial[static_cast<int64_t>(b) * kLanes + lane]);
  __shared__ float4 sums[kSumGroups][kLanes];
  sums[group][lane] = s;
  tree_sum<kSumGroups>(sums, group, lane);
  if (group == 0) out[lane] = sums[0][lane];
}

template <int NBUF>
void launch_gather(const float* table, float* partial, int off, const Schedule& s, int m,
                   int grid, cudaStream_t stream) {
  gather_rows_kernel<NBUF><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(table), reinterpret_cast<float4*>(partial), off,
      s.distinct, m, s.q, s.r);
}

}  // namespace

// table: (m, 128) f32 contiguous, 16-byte aligned; partial: (grid, 128) f32
// scratch; out: (128,) f32.  1 <= n_buf <= 16.  Launches on `stream`;
// returns the first launch error (cudaGetLastError()).
extern "C" int diffus_gather_probe(const float* table, float* partial, float* out, int off,
                                   int64_t n_rows, int m, int n_buf, int grid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Schedule s = schedule(n_rows, m);
  switch (n_buf) {
    case 1: launch_gather<1>(table, partial, off, s, m, grid, st); break;
    case 2: launch_gather<2>(table, partial, off, s, m, grid, st); break;
    case 3: launch_gather<3>(table, partial, off, s, m, grid, st); break;
    case 4: launch_gather<4>(table, partial, off, s, m, grid, st); break;
    case 5: launch_gather<5>(table, partial, off, s, m, grid, st); break;
    case 6: launch_gather<6>(table, partial, off, s, m, grid, st); break;
    case 7: launch_gather<7>(table, partial, off, s, m, grid, st); break;
    case 8: launch_gather<8>(table, partial, off, s, m, grid, st); break;
    case 9: launch_gather<9>(table, partial, off, s, m, grid, st); break;
    case 10: launch_gather<10>(table, partial, off, s, m, grid, st); break;
    case 11: launch_gather<11>(table, partial, off, s, m, grid, st); break;
    case 12: launch_gather<12>(table, partial, off, s, m, grid, st); break;
    case 13: launch_gather<13>(table, partial, off, s, m, grid, st); break;
    case 14: launch_gather<14>(table, partial, off, s, m, grid, st); break;
    case 15: launch_gather<15>(table, partial, off, s, m, grid, st); break;
    case 16: launch_gather<16>(table, partial, off, s, m, grid, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  sum_partials_kernel<<<1, kSumGroups * kLanes, 0, st>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(out), grid);
  return static_cast<int>(cudaGetLastError());
}
