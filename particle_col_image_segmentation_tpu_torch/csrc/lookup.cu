// K6: broadcast of a per-region table back to pixels.
//
// Replaces: particle_col_image_segmentation_tpu/ops/regionprops_tiles.py
//   _lookup_kernel (launched by table_lookup_mxu, dispatched by
//   table_lookup_auto).
//
// Contract (same as ops.regionprops_tiles.table_lookup):
//   out[b, p] = table[b or 0, seg[b, p]] if 0 <= seg[b, p] < R, else 0
// (-1, the CCL background label, and past-capacity ids read 0).  Exact for
// any int32 table value; the TPU kernel's two base-128 int8 digit planes
// limited it to [0, 255].
//
// Bound on this card: HBM, 8 bytes a pixel (an int32 id in, an int32 out).
// The TPU had no fast gather and picked each pixel's row with a one-hot
// matmul; here it is a bounds-checked gather, one thread per pixel,
// coalesced.  Each block handles 32K pixels of one plane and first copies
// that plane's table into shared memory when it fits (R <= 32768, 128 KB);
// larger tables are read through L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr long long kChunk = kThreads * 64;  // pixels per block
constexpr int kMaxShared = 32768;            // table entries staged in smem

__global__ void lookup_kernel(const int* __restrict__ seg, const int* __restrict__ table,
                              int* __restrict__ out, long long plane, int R,
                              int per_plane, int staged) {
  extern __shared__ int s_tab[];
  const int* tab = table + (per_plane ? (long long)blockIdx.y * R : 0);
  if (staged) {
    for (int i = threadIdx.x; i < R; i += kThreads) s_tab[i] = tab[i];
    __syncthreads();
    tab = s_tab;
  }
  const long long off = blockIdx.y * plane;
  const long long start = blockIdx.x * kChunk;
  const long long end = start + kChunk < plane ? start + kChunk : plane;
  for (long long p = start + threadIdx.x; p < end; p += kThreads) {
    const int id = seg[off + p];
    out[off + p] = (id >= 0 && id < R) ? tab[id] : 0;
  }
}

}  // namespace

extern "C" int pcis_table_lookup(const void* seg, const void* table, void* out,
                                 int B, int H, int W, int R, int per_plane,
                                 void* stream) {
  const long long plane = (long long)H * W;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || plane >= (1ll << 31) || R <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int staged = R <= kMaxShared;
  const size_t smem = staged ? sizeof(int) * (size_t)R : 0;
  cudaError_t e = cudaFuncSetAttribute(
      lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(int) * kMaxShared));
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((plane + kChunk - 1) / kChunk), B);
  lookup_kernel<<<grid, kThreads, smem, s>>>((const int*)seg, (const int*)table,
                                             (int*)out, plane, R, per_plane,
                                             staged);
  return (int)cudaGetLastError();
}
