// K4: per-region area and class tables from compact ids.
//
// Replaces: particle_col_image_segmentation_tpu/ops/regionprops_tiles.py
//   _counts_kernel (launched by _run_counts for region_counts_mxu /
//   region_sums_mxu).
//
// Contract (same as region_counts_mxu): for table rows i in [0, R1),
//   area[b, i]  = #{p : seg[b, p] == i}
//   sum         = sum of val over those pixels, saturated to the int32 range
//   class[b, i] = floor(sum / max(area, 1))      (0 on empty rows)
// Ids outside [0, R1) are dropped, not clamped.
//
// Bound on this card: shared-memory atomics on hot bins.  The TPU has no
// fast scatter, so it built the histogram from one-hot int8 matmuls on the
// MXU; here each block privatises the histogram of one plane's pixel chunk
// in dynamic shared memory (int32 area + int64 sum per bin: 16384 bins =
// 192 KB, above the 48 KB default, hence cudaFuncSetAttribute) and flushes
// non-empty bins with device atomics.  A plane's few large regions (the
// background above all) put most pixels in a handful of bins, so the lanes
// of a warp that share a bin are grouped (__match_any_sync) and add once.
// Id ranges wider than one block's bins are tiled, one launch per tile.  The
// int64 sum needs no digit split; clamping it to int32 is exactly the TPU
// kernel's _recombine_saturating.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBins = 16384;
constexpr long long kChunk = 1ll << 18;  // pixels per block

template <typename V>
__global__ void counts_kernel(const int* __restrict__ seg,
                              const V* __restrict__ val, int* area,
                              unsigned long long* sums, long long plane,
                              int R1, int r0, int nbins) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_sum = smem;
  int* s_area = (int*)(smem + nbins);
  for (int i = threadIdx.x; i < nbins; i += kThreads) {
    s_sum[i] = 0;
    s_area[i] = 0;
  }
  __syncthreads();
  const long long off = blockIdx.y * plane;
  const long long start = blockIdx.x * kChunk;
  const long long end = start + kChunk < plane ? start + kChunk : plane;
  // every thread of the block runs the same number of rounds, so whole
  // warps reach the warp intrinsics together
  for (long long base = start; base < end; base += kThreads) {
    const long long p = base + threadIdx.x;
    int key = -1;  // -1: no bin of this launch
    long long v = 0;
    if (p < end) {
      const int id = seg[off + p];
      if (id >= r0 && id < r0 + nbins) {
        key = id - r0;
        v = (long long)val[off + p];
      }
    }
    // lanes with the same bin add once, through their lowest lane; the
    // value splits into 16-bit digits so that 32-lane sums fit an int
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int sum_lo = __reduce_add_sync(peers, (int)(v & 0xffff));
    const int sum_hi = __reduce_add_sync(peers, (int)(v >> 16));
    if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
      atomicAdd(&s_area[key], __popc(peers));
      atomicAdd(&s_sum[key],
                (unsigned long long)((long long)sum_hi * 65536 + sum_lo));
    }
  }
  __syncthreads();
  const long long row = (long long)blockIdx.y * R1 + r0;
  for (int i = threadIdx.x; i < nbins; i += kThreads) {
    const int a = s_area[i];
    if (a) {
      atomicAdd(&area[row + i], a);
      atomicAdd(&sums[row + i], s_sum[i]);
    }
  }
}

__global__ void class_from_sums(const int* __restrict__ area,
                                const unsigned long long* __restrict__ sums,
                                int* __restrict__ cls, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long s = (long long)sums[i];
  if (s > 2147483647ll) s = 2147483647ll;
  if (s < -2147483648ll) s = -2147483648ll;
  const long long d = area[i] > 1 ? area[i] : 1;
  long long q = s / d;
  if (q * d != s && s < 0) --q;  // floor, as jnp's //
  cls[i] = (int)q;
}

template <typename V>
int launch(const int* seg, const V* val, int* area, int* cls,
           unsigned long long* sums, int B, long long plane, int R1,
           cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(area, 0, sizeof(int) * (size_t)B * R1, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(sums, 0, sizeof(unsigned long long) * (size_t)B * R1, s);
  if (e != cudaSuccess) return (int)e;
  const int smem_max = kMaxBins * (int)(sizeof(unsigned long long) + sizeof(int));
  e = cudaFuncSetAttribute(counts_kernel<V>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((plane + kChunk - 1) / kChunk), B);
  for (int r0 = 0; r0 < R1; r0 += kMaxBins) {
    const int nbins = R1 - r0 < kMaxBins ? R1 - r0 : kMaxBins;
    const size_t smem = (size_t)nbins * (sizeof(unsigned long long) + sizeof(int));
    counts_kernel<V><<<grid, kThreads, smem, s>>>(seg, val, area, sums, plane,
                                                  R1, r0, nbins);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long n = (long long)B * R1;
  class_from_sums<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(area, sums, cls, n);
  return (int)cudaGetLastError();
}

}  // namespace

// `sums` is caller-provided int64 scratch of B*R1 elements.
extern "C" int pcis_region_counts(const void* seg, const void* val,
                                  int val_is_u8, void* area, void* cls,
                                  void* sums, int B, int H, int W, int R1,
                                  void* stream) {
  const long long plane = (long long)H * W;
  if (B <= 0 || B > 65535 || plane <= 0 || R1 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (val_is_u8)
    return launch<uint8_t>((const int*)seg, (const uint8_t*)val, (int*)area,
                           (int*)cls, (unsigned long long*)sums, B, plane, R1, s);
  return launch<int32_t>((const int*)seg, (const int32_t*)val, (int*)area,
                         (int*)cls, (unsigned long long*)sums, B, plane, R1, s);
}
