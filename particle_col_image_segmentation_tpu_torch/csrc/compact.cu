// K3: compaction of CCL root labels to 1-based raster-rank ids.
//
// Replaces: particle_col_image_segmentation_tpu/ops/ccl_tiles.py
//   _rank_init_kernel (launched by _make_rank_init_sweep, called from
//   ops/ccl.py compact_labels_sweeps).
//
// Contract (same as ops.ccl.compact_labels): with
//   is_root[p] = raw[p] == p && raw[p] >= 0        (p = per-plane index)
//   prefix[p]  = #roots at or before p              (inclusive scan)
// seg[p] = prefix[min(raw[p], H*W-1)] for raw[p] >= 0, else 0, and
// num[b] = the plane's root count (the true count, even past any table
// capacity).
//
// Bound on this card: memory, ~16 bytes/px over four passes.  The TPU fused
// the ranks into its first band sweep because a whole-plane gather was
// slow there; on this card the gather is cheap, so the scan is written out
// as a plain three-pass per-plane scan:
//   1. root_counts:  roots per 4096-px chunk            -> partial[b, k]
//   2. scan_chunks:  exclusive scan of partial per plane -> partial, num
//   3. root_prefix:  in-chunk scan + chunk offset         -> prefix
// then 4. gather_ranks: seg[p] = prefix[raw[p]].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;

// Exclusive block-wide scan of one int per thread; *total gets the block sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int base = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return base + x - v;
}

__device__ __forceinline__ int root_bits(const int* rp, long long q, long long plane) {
  int bits = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long p = q + k;
    if (p < plane) {
      const int r = rp[p];
      bits |= (r >= 0 && (long long)r == p) << k;
    }
  }
  return bits;
}

__global__ void root_counts(const int* __restrict__ raw, int* __restrict__ partial,
                            long long plane, int nchunks) {
  const int* rp = raw + blockIdx.y * plane;
  const long long q = (long long)blockIdx.x * kChunk + threadIdx.x * kItems;
  int total;
  block_exclusive_scan(__popc(root_bits(rp, q, plane)), &total);
  if (threadIdx.x == 0) partial[blockIdx.y * (long long)nchunks + blockIdx.x] = total;
}

__global__ void scan_chunks(int* partial, int* __restrict__ num, int nchunks) {
  int* pp = partial + blockIdx.x * (long long)nchunks;
  int carry = 0;
  for (int k0 = 0; k0 < nchunks; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    const int v = k < nchunks ? pp[k] : 0;
    int total;
    const int ex = block_exclusive_scan(v, &total);
    if (k < nchunks) pp[k] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) num[blockIdx.x] = carry;
}

__global__ void root_prefix(const int* __restrict__ raw,
                            const int* __restrict__ partial,
                            int* __restrict__ prefix, long long plane,
                            int nchunks) {
  const long long off = blockIdx.y * plane;
  const long long q = (long long)blockIdx.x * kChunk + threadIdx.x * kItems;
  const int bits = root_bits(raw + off, q, plane);
  int total;
  int run = block_exclusive_scan(__popc(bits), &total) +
            partial[blockIdx.y * (long long)nchunks + blockIdx.x];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long p = q + k;
    if (p < plane) {
      run += (bits >> k) & 1;
      prefix[off + p] = run;
    }
  }
}

__global__ void gather_ranks(const int* __restrict__ raw,
                             const int* __restrict__ prefix,
                             int* __restrict__ seg, long long plane) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const long long off = blockIdx.y * plane;
  const int r = raw[off + p];
  seg[off + p] = r < 0 ? 0 : prefix[off + ((long long)r < plane ? r : plane - 1)];
}

long long chunks_per_plane(long long plane) { return (plane + kChunk - 1) / kChunk; }

}  // namespace

// Scratch ints the wrapper must provide in `partial` (per-chunk counts).
extern "C" long long pcis_compact_partial_len(int B, int H, int W) {
  return (long long)B * chunks_per_plane((long long)H * W);
}

extern "C" int pcis_compact(const void* raw, void* seg, void* num,
                            void* prefix, void* partial, long long partial_len,
                            int B, int H, int W, void* stream) {
  const long long plane = (long long)H * W;
  const long long nchunks = chunks_per_plane(plane);
  if (B <= 0 || H <= 0 || W <= 0 || plane >= (1ll << 31) || B > 65535 ||
      partial_len < B * nchunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* r = (const int*)raw;
  int* pa = (int*)partial;
  int* pre = (int*)prefix;
  dim3 cg((unsigned)nchunks, B);
  root_counts<<<cg, kThreads, 0, s>>>(r, pa, plane, (int)nchunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_chunks<<<B, kThreads, 0, s>>>(pa, (int*)num, (int)nchunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  root_prefix<<<cg, kThreads, 0, s>>>(r, pa, pre, plane, (int)nchunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gg((unsigned)((plane + 255) / 256), B);
  gather_ranks<<<gg, 256, 0, s>>>(r, pre, (int*)seg, plane);
  return (int)cudaGetLastError();
}
