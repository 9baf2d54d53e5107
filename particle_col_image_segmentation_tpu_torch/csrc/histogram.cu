// K4 as the Otsu histogram: each plane's pixels binned over its value range
// and counted, in one pass.
//
// Replaces: particle_col_image_segmentation_tpu/ops/regionprops_tiles.py
//   _counts_kernel where particle_col_image_segmentation_tpu/ops/threshold.py
//   _histogram_batch launches it on the TPU (bin ids as region ids,
//   R + 1 = bins, uint8 zeros as values).
//
// Contract (ops.histogram_tiles.bin_histogram): for plane b and k in [0, bins)
//   counts[b, k] = #{p : clip(int32(((x[b, p] - lo[b]) / span[b]) * bins), 0, bins - 1) == k}
// each step rounded to nearest in float32 (no contraction, a correctly
// rounded division, no reciprocal) and int32 by cvt.rzi, as torch's
// .to(torch.int32) on the card: truncation, saturating, NaN to 0.
//
// Bound on this card: memory, 4 B a pixel read (and 4 B a bin written).
// The TPU has no fast scatter, so it counts bin ids with K4's one-hot
// matmuls.  That route on this card (K4's table kernel on the ids) writes an
// int32 bin-id plane and a uint8 zeros plane and reads them again, and K4's
// 16-px run walk pays one 64-bit shared atomic a pixel on bin ids (a run is
// about one pixel) with one 1024-thread block an SM.  Here:
//   - each thread reads 16-byte float4s (kUnroll in flight), bins them in
//     registers and adds each pixel to a sub-histogram in shared memory;
//   - a blurred plane's noise floor puts most pixels in a few bins (four
//     bins hold 97 % of config #2's), so lanes of a warp hit one word.  Each
//     warp adds to a sub-histogram of its own (32-bit words; at 256 bins a
//     block holds 16 of 1 KB).  On the H100 this beat both ways of keeping
//     lanes off one word, __match_any_sync aggregation and 32 lane copies a
//     block (PERF.md, the K4 row): the card's shared atomics take a warp's
//     lanes on one word without the serialisation those designs pay;
//   - more bins than one block's tables hold (kTableBytes) take fewer
//     copies, warps sharing one; past kSliceBins a launch counts one slice
//     of the bins and the host launches each slice in turn, as K4's table
//     kernel does;
//   - 512-thread blocks, several an SM, each over a chunk of one plane,
//     about kWaves waves in all, so every SM is busy and the shared
//     atomics' latency hides behind other warps' loads;
//   - one merge a block: one global atomic a non-empty bin into counts
//     that one cudaMemsetAsync zeroed.  No id plane, no zeros plane, no
//     int64 sums, no class table.
// A chunk whose start is off a 16-byte boundary (odd plane sizes, or a base
// pointer off 16 bytes) takes its first pixels, and its last, one a thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                  // float4 loads in flight a thread
constexpr int kTableBytes = 64 * 1024;      // a block's sub-histograms at most
constexpr int kSliceBins = kTableBytes / 4; // bins a launch: one table
constexpr int kWaves = 4;                   // blocks: about this many waves
constexpr long long kMinChunk = 16384;      // pixels a block at least

__device__ __forceinline__ int bin_of(float v, float lo, float span, float fbins, int bins) {
  const int k = __float2int_rz(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), fbins));
  return k < 0 ? 0 : (k > bins - 1 ? bins - 1 : k);
}

// grid (chunks a plane, planes); block (c, b) counts the pixels
// [c * chunk, (c + 1) * chunk) of plane b whose bin lies in [r0, r0 + nbins),
// warp w into table w % copies of nbins words
__global__ void __launch_bounds__(kThreads, 3) histogram_kernel(
    const float* __restrict__ x, const float* __restrict__ lo_of,
    const float* __restrict__ span_of, int* __restrict__ counts, long long plane,
    long long chunk, int bins, int r0, int nbins, int copies) {
  extern __shared__ unsigned smem[];
  const int t = threadIdx.x;
  for (int i = t; i < copies * nbins; i += kThreads) smem[i] = 0;
  const int b = blockIdx.y;
  const float lo = lo_of[b], span = span_of[b], fbins = (float)bins;
  const long long start = blockIdx.x * chunk;
  const long long n = (start + chunk < plane ? start + chunk : plane) - start;
  const float* p = x + b * plane + start;
  unsigned* tab = smem + ((t >> 5) % copies) * nbins;
  auto add = [&](float v) {
    const int k = bin_of(v, lo, span, fbins, bins) - r0;
    if ((unsigned)k < (unsigned)nbins) atomicAdd(tab + k, 1u);
  };
  int head = (int)(((16 - ((uintptr_t)p & 15)) & 15) >> 2);  // floats up to 16 B
  if (head > n) head = (int)n;
  const long long n4 = (n - head) >> 2;
  const int tail = (int)((n - head) & 3);
  const float4* p4 = reinterpret_cast<const float4*>(p + head);
  __syncthreads();
  // the head and the tail, a pixel a thread
  if (t < head) add(p[t]);
  else if (t >= 4 && t - 4 < tail) add(p[head + 4 * n4 + t - 4]);
  for (long long base = 0; base < n4; base += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * kThreads + t;
      if (j < n4) v[u] = __ldg(p4 + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads + t < n4) {
        add(v[u].x);
        add(v[u].y);
        add(v[u].z);
        add(v[u].w);
      }
    }
  }
  __syncthreads();
  int* out = counts + (long long)b * bins + r0;
  for (int k = t; k < nbins; k += kThreads) {
    unsigned c = 0;
    for (int w = 0; w < copies; ++w) c += smem[w * nbins + k];
    if (c) atomicAdd(out + k, (int)c);
  }
}

}  // namespace

// x: float32 [B, H, W]; lo, span: float32 [B] on the card; counts: int32
// [B, bins].
extern "C" int pcis_bin_histogram(const void* x, const void* lo, const void* span,
                                  void* counts, int B, int H, int W, int bins, void* stream) {
  const long long plane = (long long)H * W;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || plane >= (1ll << 31) || bins <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)B * bins, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kTableBytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  for (long long r0 = 0; r0 < bins; r0 += kSliceBins) {
    const int nbins = (int)(bins - r0 < kSliceBins ? bins - r0 : kSliceBins);
    int copies = kTableBytes / (4 * nbins);
    if (copies > kWarps) copies = kWarps;
    const size_t smem = (size_t)4 * copies * nbins;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, histogram_kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    // about kWaves waves of blocks over the batch, each chunk at least
    // kMinChunk px (a small plane takes one block) and a whole number of
    // float4s
    long long per_plane = ((long long)kWaves * sms * (occ > 0 ? occ : 1) + B - 1) / B;
    const long long most = (plane + kMinChunk - 1) / kMinChunk;
    if (per_plane > most) per_plane = most;
    long long chunk = (plane + per_plane - 1) / per_plane;
    chunk = (chunk + 3) / 4 * 4;
    per_plane = (plane + chunk - 1) / chunk;
    dim3 grid((unsigned)per_plane, B);
    histogram_kernel<<<grid, kThreads, smem, s>>>((const float*)x, (const float*)lo,
                                                  (const float*)span, (int*)counts, plane,
                                                  chunk, bins, (int)r0, nbins, copies);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
