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
// Bound on this card: memory, 5 B a pixel for uint8 values (9 for int32).
// The TPU has no fast scatter, so it built the histogram from one-hot int8
// matmuls on the MXU.  Here a block privatises one chunk of one plane's
// histogram in shared memory and flushes the non-empty bins with device
// atomics.  A one-pixel-a-round design is latency-bound (one dependent 5-byte
// load a thread a round) and pays a warp vote and shared atomics on every
// pixel, though most pixels lie in a few large regions whose ids repeat along
// a row.  So:
//   - runs in registers: a thread takes 16 consecutive pixels (four 16-byte
//     loads of ids, one of uint8 values or four of int32), all loads issued
//     before use, and keeps (id, count, sum) of the current run, adding to
//     the shared table only where the id changes;
//   - the last run of each thread (the whole 16 px on a region's interior)
//     goes through one __match_any_sync group a warp, so a hot bin takes one
//     shared atomic a warp per 512 px;
//   - uint8 values: count and sum share one 64-bit bin (count << 40 | sum):
//     one atomic a run, 8 B a bin.  Exact while a block holds fewer than
//     2^24 pixels (sum < 255 * 2^24 < 2^40); the grid keeps 2^23.  int32 values
//     keep an int32 count and an int64 sum (12 B a bin);
//   - one wave: about one 1024-thread block an SM (planes x chunks), so each
//     block clears and flushes its bins once for a large chunk.
// The 16-px groups are aligned in the batch's flat index, so a plane that
// starts off a 16-byte boundary (odd H*W) costs nothing but masked pixels;
// a base pointer off 16 bytes takes scalar loads.  Id ranges wider than one
// block's bins are tiled, one launch a tile.  Clamping the int64 sum to int32
// is exactly the TPU kernel's _recombine_saturating.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRun = 16;                      // pixels a thread takes at a time
constexpr int kMaxBinsU8 = 28672;             // 8 B a bin: 224 KB
constexpr int kMaxBinsI32 = 18432;            // 12 B a bin: 216 KB
constexpr long long kMaxChunk = 1ll << 23;    // pixels a block: counts below 2^24
constexpr int kCountShift = 40;
constexpr unsigned long long kSumMask = (1ull << kCountShift) - 1;
constexpr unsigned kFull = 0xffffffffu;

template <typename V>
__host__ __device__ constexpr int max_bins() { return sizeof(V) == 1 ? kMaxBinsU8 : kMaxBinsI32; }

template <typename V>
__host__ __device__ constexpr int bin_bytes() { return sizeof(V) == 1 ? 8 : 12; }

// 64-bit words of shared memory that nbins bins take
template <typename V>
__host__ __device__ constexpr int table_words(int nbins) {
  return (nbins * bin_bytes<V>() + 7) / 8;
}

// The run of 16 px at flat index g (g % 16 == 0): ids, and values as 32-bit
// words (four bytes a word for uint8, one value a word for int32).  Pixels
// past the batch read id -1.
template <typename V>
__device__ __forceinline__ void load_run(const int* __restrict__ seg, const V* __restrict__ val,
                                         long long g, long long n, bool vec, int (&id)[kRun],
                                         unsigned (&vw)[kRun * sizeof(V) / 4]) {
  if (vec && g + kRun <= n) {
    const int4* s4 = reinterpret_cast<const int4*>(seg + g);
    const uint4* v4 = reinterpret_cast<const uint4*>(val + g);
#pragma unroll
    for (int i = 0; i < kRun / 4; ++i) {
      const int4 a = __ldg(s4 + i);
      id[4 * i] = a.x;
      id[4 * i + 1] = a.y;
      id[4 * i + 2] = a.z;
      id[4 * i + 3] = a.w;
    }
#pragma unroll
    for (int i = 0; i < kRun * (int)sizeof(V) / 16; ++i) {
      const uint4 b = __ldg(v4 + i);
      vw[4 * i] = b.x;
      vw[4 * i + 1] = b.y;
      vw[4 * i + 2] = b.z;
      vw[4 * i + 3] = b.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k) id[k] = g + k < n ? seg[g + k] : -1;
  if constexpr (sizeof(V) == 1) {
#pragma unroll
    for (int i = 0; i < kRun / 4; ++i) {
      unsigned w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (g + 4 * i + k < n) w |= (unsigned)val[g + 4 * i + k] << (8 * k);
      vw[i] = w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) vw[k] = g + k < n ? (unsigned)val[g + k] : 0u;
  }
}

template <typename V>
__device__ __forceinline__ long long value_at(const unsigned (&vw)[kRun * sizeof(V) / 4], int k) {
  if constexpr (sizeof(V) == 1) return (vw[k >> 2] >> (8 * (k & 3))) & 0xff;
  else return (long long)(int)vw[k];
}

// Add a run of `cnt` pixels summing to `sum` to shared bin `key`.
template <typename V>
__device__ __forceinline__ void add_run(unsigned long long* tab, int nbins, int key,
                                        unsigned cnt, long long sum) {
  if constexpr (sizeof(V) == 1) {
    atomicAdd(&tab[key], ((unsigned long long)cnt << kCountShift) | (unsigned long long)sum);
  } else {
    atomicAdd(&tab[key], (unsigned long long)sum);
    atomicAdd(reinterpret_cast<unsigned*>(tab + nbins) + key, cnt);
  }
}

// grid (chunks a plane, planes); block (c, b) takes pixels [lo, hi) of plane b
template <typename V>
__global__ void __launch_bounds__(kThreads, 1) counts_kernel(
    const int* __restrict__ seg, const V* __restrict__ val, int* area,
    unsigned long long* sums, long long plane, long long chunk, int R1, int r0,
    int nbins, bool vec) {
  extern __shared__ unsigned long long tab[];
  // uint8: tab[i] = count << 40 | sum.  int32: tab[i] = sum, then the counts
  for (int i = threadIdx.x; i < table_words<V>(nbins); i += kThreads) tab[i] = 0;
  __syncthreads();
  const long long n = (long long)gridDim.y * plane;
  const long long lo = blockIdx.y * plane + blockIdx.x * chunk;
  const long long hi = blockIdx.y * plane +
                       ((blockIdx.x + 1) * chunk < plane ? (blockIdx.x + 1) * chunk : plane);
  const long long G0 = lo / kRun, G1 = (hi + kRun - 1) / kRun;
  const int lane = threadIdx.x & 31;
  // every thread of the block runs the same number of rounds, so whole
  // warps reach the warp intrinsics together
  for (long long base = G0; base < G1; base += kThreads) {
    const long long G = base + threadIdx.x;
    int key = -1;  // -1: a run that no bin of this launch takes
    unsigned cnt = 0;
    long long sum = 0;
    if (G < G1) {
      int id[kRun];
      unsigned vw[kRun * sizeof(V) / 4];
      load_run<V>(seg, val, G * kRun, n, vec, id, vw);
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const long long p = G * kRun + k;
        const int kk = p >= lo && p < hi && id[k] >= r0 && id[k] - r0 < nbins ? id[k] - r0 : -1;
        const long long v = value_at<V>(vw, k);
        if (kk == key) {
          ++cnt;
          sum += v;
        } else {
          if (key >= 0) add_run<V>(tab, nbins, key, cnt, sum);
          key = kk;
          cnt = 1;
          sum = v;
        }
      }
    }
    // the last run: lanes with the same bin add once, through their lowest lane
    const unsigned peers = __match_any_sync(kFull, key);
    const unsigned cnt_all = __reduce_add_sync(peers, cnt);
    long long sum_all;
    if constexpr (sizeof(V) == 1) {
      sum_all = __reduce_add_sync(peers, (unsigned)sum);  // <= 32 * 16 * 255
    } else {  // |sum| < 2^35: 24-bit low digits and the signed rest, each fits 32 lanes
      const unsigned lo24 = __reduce_add_sync(peers, (unsigned)(sum & 0xffffff));
      const int hi = __reduce_add_sync(peers, (int)(sum >> 24));
      sum_all = (long long)hi * (1ll << 24) + lo24;
    }
    if (key >= 0 && lane == __ffs(peers) - 1) add_run<V>(tab, nbins, key, cnt_all, sum_all);
  }
  __syncthreads();
  const long long row = (long long)blockIdx.y * R1 + r0;
  for (int i = threadIdx.x; i < nbins; i += kThreads) {
    unsigned a;
    unsigned long long s;
    if constexpr (sizeof(V) == 1) {
      a = (unsigned)(tab[i] >> kCountShift);
      s = tab[i] & kSumMask;
    } else {
      a = reinterpret_cast<const unsigned*>(tab + nbins)[i];
      s = tab[i];
    }
    if (a) {
      atomicAdd(&area[row + i], (int)a);
      atomicAdd(&sums[row + i], s);
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
  e = cudaFuncSetAttribute(counts_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           table_words<V>(max_bins<V>()) * 8);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // about one block an SM in one wave, each chunk at most kMaxChunk px and a
  // whole number of runs
  long long per_plane = sms / B > 1 ? sms / B : 1;
  const long long min_chunks = (plane + kMaxChunk - 1) / kMaxChunk;
  if (per_plane < min_chunks) per_plane = min_chunks;
  long long chunk = (plane + per_plane - 1) / per_plane;
  chunk = (chunk + kRun - 1) / kRun * kRun;
  per_plane = (plane + chunk - 1) / chunk;
  const bool vec = ((uintptr_t)seg | (uintptr_t)val) % 16 == 0;
  dim3 grid((unsigned)per_plane, B);
  for (int r0 = 0; r0 < R1; r0 += max_bins<V>()) {
    const int nbins = R1 - r0 < max_bins<V>() ? R1 - r0 : max_bins<V>();
    const size_t smem = (size_t)table_words<V>(nbins) * 8;
    counts_kernel<V><<<grid, kThreads, smem, s>>>(seg, val, area, sums, plane, chunk,
                                                  R1, r0, nbins, vec);
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
