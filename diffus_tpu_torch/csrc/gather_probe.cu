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
// Design: one warp per 512-byte row, each lane one 16-byte float4 (the
// whole row is one coalesced 512-byte transaction).  Warp w of T in the
// grid takes rows i = w, w + T, w + 2T, ... and keeps NBUF (= n_buf) row
// loads in flight: the loads of NBUF rows are issued, unrolled, before any
// of them is added.  Each block sums its warps' registers through shared
// memory into one row of a (G, 128) partials buffer; a second kernel sums
// the G partials of each column in block order.  The order of every sum is
// fixed, so the result is deterministic and no atomics are needed.
//
// Row ids: the Pallas kernel computes off + 97 i in int32 and takes jnp's
// floor modulo, which is never negative.  C's % keeps the dividend's sign,
// so the id is ((x % m) + m) % m, in 64 bits; the wrapper refuses inputs
// where off + 97 (n_rows - 1) leaves int32, so 64 bits give the same ids.
//
// What bounds it on the card: random 512-byte reads, n_rows x 512 bytes in
// all (512 MiB at n_rows = 2^20) from a table (64 MiB at M = 131072) a
// little larger than the 50 MB L2.  The rows 97 apart are not neighbours,
// so each read is its own transaction; the loads in flight per SM
// (warps x NBUF x 512 bytes) hide the latency.  The adds are negligible.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 32;          // 32 lanes x float4 = one 128-float row
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kLanes * kWarpsPerBlock;
constexpr int kRowFloats = 128;

__device__ __forceinline__ int64_t row_id(int64_t off, int64_t i, int64_t m) {
  return (((off + 97 * i) % m) + m) % m;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <int NBUF>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table, float4* __restrict__ partial, int off,
                   int64_t n_rows, int m) {
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int64_t total = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc = zero;
  for (int64_t base = first; base < n_rows; base += NBUF * total) {
    float4 v[NBUF];
#pragma unroll
    for (int k = 0; k < NBUF; ++k) {
      const int64_t i = base + k * total;
      v[k] = i < n_rows ? __ldg(table + row_id(off, i, m) * kLanes + lane) : zero;
    }
#pragma unroll
    for (int k = 0; k < NBUF; ++k) add4(acc, v[k]);
  }
  __shared__ float4 warp_sums[kWarpsPerBlock][kLanes];
  warp_sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float4 s = warp_sums[0][lane];
    for (int w = 1; w < kWarpsPerBlock; ++w) add4(s, warp_sums[w][lane]);
    partial[static_cast<int64_t>(blockIdx.x) * kLanes + lane] = s;
  }
}

// out[j] = partial[0][j] + partial[1][j] + ... + partial[g-1][j]
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int g) {
  const int j = threadIdx.x;
  float s = 0.0f;
  for (int b = 0; b < g; ++b) s += partial[static_cast<int64_t>(b) * kRowFloats + j];
  out[j] = s;
}

template <int NBUF>
void launch_gather(const float* table, float* partial, int off, int64_t n_rows, int m, int grid,
                   cudaStream_t stream) {
  gather_rows_kernel<NBUF><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(table), reinterpret_cast<float4*>(partial), off, n_rows,
      m);
}

}  // namespace

// table: (m, 128) f32 contiguous, 16-byte aligned; partial: (grid, 128) f32
// scratch; out: (128,) f32.  1 <= n_buf <= 16.  Launches on `stream`;
// returns the first launch error (cudaGetLastError()).
extern "C" int diffus_gather_probe(const float* table, float* partial, float* out, int off,
                                   int64_t n_rows, int m, int n_buf, int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_buf) {
    case 1: launch_gather<1>(table, partial, off, n_rows, m, grid, s); break;
    case 2: launch_gather<2>(table, partial, off, n_rows, m, grid, s); break;
    case 3: launch_gather<3>(table, partial, off, n_rows, m, grid, s); break;
    case 4: launch_gather<4>(table, partial, off, n_rows, m, grid, s); break;
    case 5: launch_gather<5>(table, partial, off, n_rows, m, grid, s); break;
    case 6: launch_gather<6>(table, partial, off, n_rows, m, grid, s); break;
    case 7: launch_gather<7>(table, partial, off, n_rows, m, grid, s); break;
    case 8: launch_gather<8>(table, partial, off, n_rows, m, grid, s); break;
    case 9: launch_gather<9>(table, partial, off, n_rows, m, grid, s); break;
    case 10: launch_gather<10>(table, partial, off, n_rows, m, grid, s); break;
    case 11: launch_gather<11>(table, partial, off, n_rows, m, grid, s); break;
    case 12: launch_gather<12>(table, partial, off, n_rows, m, grid, s); break;
    case 13: launch_gather<13>(table, partial, off, n_rows, m, grid, s); break;
    case 14: launch_gather<14>(table, partial, off, n_rows, m, grid, s); break;
    case 15: launch_gather<15>(table, partial, off, n_rows, m, grid, s); break;
    case 16: launch_gather<16>(table, partial, off, n_rows, m, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  sum_partials_kernel<<<1, kRowFloats, 0, s>>>(partial, out, grid);
  return static_cast<int>(cudaGetLastError());
}
