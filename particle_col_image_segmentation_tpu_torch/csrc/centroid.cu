// K7: the centroid table (area and coordinate digit sums) from compact ids.
//
// Replaces: particle_col_image_segmentation_tpu/ops/regionprops_tiles.py
//   _centroid_kernel (launched by centroid_sums_mxu, dispatched by
//   centroid_sums_auto).
//
// Contract (same as ops.regionprops.centroid_sums): for table rows i in
// [0, R1) of plane b, over the pixels p = (r, c) with seg[b, p] == i,
//   area  = #p
//   sr_hi = sum(r >> 7), sr_lo = sum(r & 127)   (digit sums, each summed on
//   sc_hi = sum(c >> 7), sc_lo = sum(c & 127)    its own, int32)
// Ids outside [0, R1) are dropped; empty rows hold 0.
//
// Bound on this card: reading the ids (4 B a pixel) and the shared-memory
// atomics on the few hot bins (id 0, background plus unreached pixels,
// holds most pixels).  The TPU built the table from one-hot int8 matmuls on
// the MXU; here each block privatises the five columns of one id range in
// shared memory (20 B a bin: 80 KB at R1 = 4096), computes each pixel's
// four digits from its (r, c) in registers, and groups the lanes of a warp
// that share an id with __match_any_sync, so that a uniform warp costs one
// shared atomic per column.  The block flushes each touched bin with one
// global atomicAdd per column.  When R1 is too large for one block the id
// range is tiled over blockIdx.z, and a warp with no id in its block's tile
// skips the round after one ballot.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 5;                 // area, sr_hi, sr_lo, sc_hi, sc_lo
constexpr int kMaxBins = 11264;          // 11264 * 20 B = 225,280 B
constexpr long long kChunk = 1ll << 16;  // pixels per block

__global__ void centroid_kernel(const int* __restrict__ seg, int* __restrict__ cols,
                                int W, long long plane, long long n, int R1,
                                int nbins) {
  extern __shared__ int s[];  // column k of bin i at s[k * nbins + i]
  const int r0 = blockIdx.z * nbins;
  const int nb = min(nbins, R1 - r0);
  for (int i = threadIdx.x; i < kCols * nbins; i += kThreads) s[i] = 0;
  __syncthreads();
  const long long off = blockIdx.y * plane;
  const long long start = blockIdx.x * kChunk;
  const long long end = start + kChunk < plane ? start + kChunk : plane;
  const int lane = threadIdx.x & 31;
  // every thread runs the same number of rounds, so whole warps reach the
  // warp intrinsics together
  for (long long base = start; base < end; base += kThreads) {
    const long long p = base + threadIdx.x;
    int key = -1, r = 0, c = 0;  // key -1: no bin of this block
    if (p < end) {
      const int id = seg[off + p];
      if (id >= r0 && id < r0 + nb) {
        key = id - r0;
        r = (int)(p / W);
        c = (int)(p - (long long)r * W);
      }
    }
    if (!__ballot_sync(0xffffffffu, key >= 0)) continue;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int srh = __reduce_add_sync(peers, r >> 7);
    const int srl = __reduce_add_sync(peers, r & 127);
    const int sch = __reduce_add_sync(peers, c >> 7);
    const int scl = __reduce_add_sync(peers, c & 127);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&s[key], __popc(peers));
      atomicAdd(&s[nbins + key], srh);
      atomicAdd(&s[2 * nbins + key], srl);
      atomicAdd(&s[3 * nbins + key], sch);
      atomicAdd(&s[4 * nbins + key], scl);
    }
  }
  __syncthreads();
  const long long row = (long long)blockIdx.y * R1 + r0;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    if (!s[i]) continue;  // no pixel of this chunk: every column is 0
#pragma unroll
    for (int k = 0; k < kCols; ++k) atomicAdd(&cols[k * n + row + i], s[k * nbins + i]);
  }
}

}  // namespace

// cols: int32 [5, B, R1] (area, sr_hi, sr_lo, sc_hi, sc_lo), zeroed here.
extern "C" int pcis_centroid_sums(const void* seg, void* cols, int B, int H,
                                  int W, int R1, void* stream) {
  const long long plane = (long long)H * W;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || plane >= (1ll << 31) ||
      R1 <= 0 || (R1 + kMaxBins - 1) / kMaxBins > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * R1;
  cudaError_t e = cudaMemsetAsync(cols, 0, sizeof(int) * kCols * (size_t)n, s);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (R1 + kMaxBins - 1) / kMaxBins;
  const int nbins = (R1 + ntiles - 1) / ntiles;
  const size_t smem = (size_t)nbins * kCols * sizeof(int);
  e = cudaFuncSetAttribute(centroid_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((plane + kChunk - 1) / kChunk), B, ntiles);
  centroid_kernel<<<grid, kThreads, smem, s>>>((const int*)seg, (int*)cols, W,
                                               plane, n, R1, nbins);
  return (int)cudaGetLastError();
}
