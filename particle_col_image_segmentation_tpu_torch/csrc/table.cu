// K5: the full per-region table (RegionTable) from compact ids.
//
// Replaces: particle_col_image_segmentation_tpu/ops/regionprops_tiles.py
//   _table_kernel (launched by _run_table for region_table_mxu, dispatched
//   by region_props_auto).
//
// Contract (same as ops.regionprops.region_props): for table rows i in
// [0, R1) of plane b, over the pixels p = (r, c) with seg[b, p] == i,
//   area  = #p
//   sr_hi = sum(r >> 7), sr_lo = sum(r & 127)   (digit sums, each summed on
//   sc_hi = sum(c >> 7), sc_lo = sum(c & 127)    its own: not a split of
//                                                sum(r), int32)
//   class = floor(sum(val) saturated to int32 / max(area, 1))
//   bbox  = (min r, min c, max r + 1, max c + 1), and (0, 0, 0, 0) on empty
//           rows, where every other column is 0 too.
// Ids outside [0, R1) are dropped.
//
// Bound on this card: shared-memory atomics on a plane's few hot regions
// (the background region holds most pixels).  The TPU accumulated one-hot
// int8 matmuls on the MXU, plus a second pass over the transposed plane for
// the column extremes; here each block privatises the bins of one id range
// for one plane chunk in dynamic shared memory (44 B a bin: an int64 value
// sum and nine int32 columns), the lanes of a warp that share a bin are
// grouped with __match_any_sync and reduce with __reduce_*_sync, so a
// uniform warp costs one shared atomic per column, and the extremes come
// straight from atomicMin/atomicMax: no transposed pass.  At R1 = 16385
// the 9 columns do not fit one block, so the id range is tiled over
// blockIdx.z (4 tiles of 4097 bins); a warp with no id in its block's tile
// skips all of it after one ballot.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBins = 5120;               // 5120 * 44 B = 225,280 B
constexpr int kIntCols = 9;                  // area, 4 digit sums, 4 extremes
constexpr int kBinBytes = 8 + 4 * kIntCols;  // + the int64 value sum
constexpr long long kChunk = 1ll << 18;      // pixels per block

template <typename V>
__global__ void table_kernel(const int* __restrict__ seg, const V* __restrict__ val,
                             int* __restrict__ cols, int* __restrict__ ext,
                             unsigned long long* __restrict__ vsum, int W,
                             long long plane, long long n, int R1, int nbins) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_val = smem;
  int* s = (int*)(smem + nbins);  // column k of bin i at s[k * nbins + i]
  const int r0 = blockIdx.z * nbins;
  const int nb = min(nbins, R1 - r0);
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    s_val[i] = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) s[k * nbins + i] = 0;
    s[5 * nbins + i] = INT_MAX;  // min r
    s[6 * nbins + i] = INT_MAX;  // min c
    s[7 * nbins + i] = -1;       // max r
    s[8 * nbins + i] = -1;       // max c
  }
  __syncthreads();
  const long long off = blockIdx.y * plane;
  const long long start = blockIdx.x * kChunk;
  const long long end = start + kChunk < plane ? start + kChunk : plane;
  const int lane = threadIdx.x & 31;
  // every thread of the block runs the same number of rounds, so whole
  // warps reach the warp intrinsics together
  for (long long base = start; base < end; base += kThreads) {
    const long long p = base + threadIdx.x;
    int key = -1, r = 0, c = 0;  // key -1: no bin of this block
    long long v = 0;
    if (p < end) {
      const int id = seg[off + p];
      if (id >= r0 && id < r0 + nb) {
        key = id - r0;
        v = (long long)val[off + p];
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
    // 16-bit value digits, so that 32-lane sums of int32 values fit an int
    const int vlo = __reduce_add_sync(peers, (int)(v & 0xffff));
    const int vhi = __reduce_add_sync(peers, (int)(v >> 16));
    const int mnr = __reduce_min_sync(peers, r);
    const int mnc = __reduce_min_sync(peers, c);
    const int mxr = __reduce_max_sync(peers, r);
    const int mxc = __reduce_max_sync(peers, c);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&s[key], __popc(peers));
      atomicAdd(&s[nbins + key], srh);
      atomicAdd(&s[2 * nbins + key], srl);
      atomicAdd(&s[3 * nbins + key], sch);
      atomicAdd(&s[4 * nbins + key], scl);
      atomicAdd(&s_val[key], (unsigned long long)((long long)vhi * 65536 + vlo));
      atomicMin(&s[5 * nbins + key], mnr);
      atomicMin(&s[6 * nbins + key], mnc);
      atomicMax(&s[7 * nbins + key], mxr);
      atomicMax(&s[8 * nbins + key], mxc);
    }
  }
  __syncthreads();
  const long long row = (long long)blockIdx.y * R1 + r0;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    if (!s[i]) continue;
    const long long g = row + i;
#pragma unroll
    for (int k = 0; k < 5; ++k) atomicAdd(&cols[k * n + g], s[k * nbins + i]);
    atomicAdd(&vsum[g], s_val[i]);
    atomicMin(&ext[4 * g], s[5 * nbins + i]);
    atomicMin(&ext[4 * g + 1], s[6 * nbins + i]);
    atomicMax(&ext[4 * g + 2], s[7 * nbins + i]);
    atomicMax(&ext[4 * g + 3], s[8 * nbins + i]);
  }
}

__global__ void init_extremes(int* ext, long long n) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  ext[4 * g] = INT_MAX;
  ext[4 * g + 1] = INT_MAX;
  ext[4 * g + 2] = -1;
  ext[4 * g + 3] = -1;
}

// class = floor(clamped sum / max(area, 1)); bbox half-open, zeros if empty
__global__ void finalize(int* cols, int* ext, const unsigned long long* vsum,
                         long long n) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int a = cols[g];
  long long sum = (long long)vsum[g];
  sum = sum > INT_MAX ? INT_MAX : (sum < INT_MIN ? INT_MIN : sum);
  const long long d = a > 1 ? a : 1;
  long long q = sum / d;
  if (q * d != sum && sum < 0) --q;  // floor, as torch's floor division
  cols[5 * n + g] = (int)q;
  if (a == 0) {
    ext[4 * g] = ext[4 * g + 1] = ext[4 * g + 2] = ext[4 * g + 3] = 0;
  } else {
    ext[4 * g + 2] += 1;
    ext[4 * g + 3] += 1;
  }
}

template <typename V>
int launch(const int* seg, const V* val, int* cols, int* ext,
           unsigned long long* vsum, int B, int W, long long plane, int R1,
           cudaStream_t s) {
  const long long n = (long long)B * R1;
  cudaError_t e = cudaMemsetAsync(cols, 0, sizeof(int) * 5 * (size_t)n, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(vsum, 0, sizeof(unsigned long long) * (size_t)n, s);
  if (e != cudaSuccess) return (int)e;
  const unsigned eb = (unsigned)((n + 255) / 256);
  init_extremes<<<eb, 256, 0, s>>>(ext, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (R1 + kMaxBins - 1) / kMaxBins;
  const int nbins = (R1 + ntiles - 1) / ntiles;
  const size_t smem = (size_t)nbins * kBinBytes;
  e = cudaFuncSetAttribute(table_kernel<V>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((plane + kChunk - 1) / kChunk), B, ntiles);
  table_kernel<V><<<grid, kThreads, smem, s>>>(seg, val, cols, ext, vsum, W,
                                               plane, n, R1, nbins);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finalize<<<eb, 256, 0, s>>>(cols, ext, vsum, n);
  return (int)cudaGetLastError();
}

}  // namespace

// cols: int32 [6, B, R1] (area, sr_hi, sr_lo, sc_hi, sc_lo, class_id);
// bbox: int32 [B, R1, 4]; vsum: int64 scratch of B*R1 elements.
extern "C" int pcis_region_table(const void* seg, const void* val, int val_is_u8,
                                 void* cols, void* bbox, void* vsum, int B,
                                 int H, int W, int R1, void* stream) {
  const long long plane = (long long)H * W;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || plane >= (1ll << 31) ||
      R1 <= 0 || (R1 + kMaxBins - 1) / kMaxBins > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (val_is_u8)
    return launch<uint8_t>((const int*)seg, (const uint8_t*)val, (int*)cols,
                           (int*)bbox, (unsigned long long*)vsum, B, W, plane,
                           R1, s);
  return launch<int32_t>((const int*)seg, (const int32_t*)val, (int*)cols,
                         (int*)bbox, (unsigned long long*)vsum, B, W, plane,
                         R1, s);
}
