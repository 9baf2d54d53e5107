// K3: compaction of CCL root labels to 1-based raster-rank ids.
//
// Replaces: particle_col_image_segmentation_tpu/ops/ccl_tiles.py
//   _rank_init_kernel (launched by _make_rank_init_sweep, called from
//   ops/ccl.py compact_labels_sweeps).
//
// Contract (same as ops.ccl.compact_labels), for any int32 raw, not only CCL
// output (raw[p] may point forward, at a non-root or past the plane):
//   is_root[p] = raw[p] == p                        (p = per-plane index)
//   seg[p]     = #{roots q <= min(raw[p], H*W-1)}  for raw[p] >= 0, else 0
//   num[b]     = the plane's root count (the true count, past any capacity).
//
// Bound on this card: memory.  The function must read raw once and write seg
// once, 8 B a pixel.  The TPU fused the ranks into its first band sweep
// because a whole-plane gather was slow there; here the gather is cheap and
// the cost is the traffic.  No prefix plane is kept:
//   1. compact_bits reads raw with 16-byte loads and stores the root
//      indicator as one bit a pixel (eight lanes' nibbles joined by three
//      shuffles), with each 32-px word's roots before it in its 4096-px
//      tile beside it (8 B per 32 px), and each tile's root count.  One
//      barrier a tile; nothing waits on another block.
//   2. scan_tiles, one block, turns the tile counts into exclusive prefixes.
//   3. compact_ranks reads raw again and writes seg: any index's inclusive
//      rank is its tile's prefix + its word's prefix + a popcount.
//      Neighbouring pixels share their root, so the lookups hit L1/L2.
// That is ~12.25 B a pixel.  A decoupled look-back (tiles publishing their
// counts in ticket order) in place of step 2 kept step 1's blocks waiting on
// their predecessors: 0.311 ms against 0.195 + 0.014 for steps 1 and 2 at
// [32,2048²] on an H100 SXM at 700 W.  A single pass would hold only for
// labels that point backwards, which the contract does not promise.  The
// whole batch is one flat index space g = b*H*W + p, so plane starts need
// no alignment; a plane's ranks are differences of the flat prefix, kept
// mod 2^32 (each plane's true count is below 2^31, so they are exact).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                  // 16-byte loads a thread
constexpr int kStride = kThreads * 4;     // px between a thread's loads
constexpr int kChunk = kStride * kVecs;   // 4096 px a tile
constexpr int kTileShift = 12;            // log2(kChunk)
constexpr int kTileWords = kChunk / 32;   // 128 bit words a tile
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk == 1 << kTileShift, "tile lookups shift by kTileShift");

// raw[g..g+3]; past the batch (g >= n) reads -1, which is never a root
template <bool kVec>
__device__ __forceinline__ int4 load4(const int* __restrict__ raw, long long g, long long n) {
  if (kVec && g + 4 <= n) return __ldg(reinterpret_cast<const int4*>(raw + g));
  int4 v;
  v.x = g < n ? raw[g] : -1;
  v.y = g + 1 < n ? raw[g + 1] : -1;
  v.z = g + 2 < n ? raw[g + 2] : -1;
  v.w = g + 3 < n ? raw[g + 3] : -1;
  return v;
}

// Index within its plane of the pixel `off` past a tile whose first pixel
// sits at `pstart` of its plane (pstart < plane, off < kChunk).
__device__ __forceinline__ unsigned in_plane(unsigned pstart, unsigned off, unsigned plane) {
  const unsigned p = pstart + off;
  if (p < plane) return p;
  return plane >= (unsigned)kChunk ? p - plane : p % plane;
}

// words[w] = {root bits of flat px 32w.., roots of its tile before them};
// tile_roots[t] = roots in tile t
template <bool kVec>
__global__ void __launch_bounds__(kThreads) compact_bits(
    const int* __restrict__ raw, uint2* __restrict__ words, unsigned* __restrict__ tile_roots,
    long long n, long long nwords, unsigned plane) {
  __shared__ unsigned s_cnt[kVecs * kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, group = lane >> 3;
  const long long tile = blockIdx.x;
  const long long g0 = tile * kChunk;
  const unsigned pstart = (unsigned)(g0 % plane);
  int4 v[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) v[j] = load4<kVec>(raw, g0 + j * kStride + 4 * tid, n);
  unsigned word[kVecs], within[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const unsigned off = j * kStride + 4 * tid;
    unsigned nib = (unsigned)(v[j].x == (int)in_plane(pstart, off, plane));
    nib |= (unsigned)(v[j].y == (int)in_plane(pstart, off + 1, plane)) << 1;
    nib |= (unsigned)(v[j].z == (int)in_plane(pstart, off + 2, plane)) << 2;
    nib |= (unsigned)(v[j].w == (int)in_plane(pstart, off + 3, plane)) << 3;
    // eight lanes' nibbles make one word; every lane of the eight gets it
    unsigned w = nib << (4 * (lane & 7));
    w |= __shfl_xor_sync(kFull, w, 1);
    w |= __shfl_xor_sync(kFull, w, 2);
    w |= __shfl_xor_sync(kFull, w, 4);
    word[j] = w;
    const unsigned c = __popc(w);
    const unsigned c0 = __shfl_sync(kFull, c, 0), c1 = __shfl_sync(kFull, c, 8);
    const unsigned c2 = __shfl_sync(kFull, c, 16), c3 = __shfl_sync(kFull, c, 24);
    within[j] = (group > 0 ? c0 : 0) + (group > 1 ? c1 : 0) + (group > 2 ? c2 : 0);
    if (lane == 0) s_cnt[j * (kThreads / 32) + warp] = c0 + c1 + c2 + c3;
  }
  __syncthreads();
  // s_cnt is in raster order (load-major, then warp); every warp scans it
  // itself, so a tile needs one barrier
  const unsigned x = s_cnt[lane];
  unsigned inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  const unsigned excl = inc - x;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const unsigned before = __shfl_sync(kFull, excl, j * (kThreads / 32) + warp);
    if ((lane & 7) == 0) {
      const long long wi = tile * kTileWords + j * (kThreads / 8) + warp * 4 + group;
      if (wi < nwords) words[wi] = make_uint2(word[j], before + within[j]);
    }
  }
  const unsigned total = __shfl_sync(kFull, inc, 31);
  if (tid == 0) tile_roots[tile] = total;
}

// Exclusive scan of the tile totals in place (mod 2^32), one block.  A round
// gives each warp 1024 consecutive totals, read and written as 32 coalesced
// loads and stores, scanned with shuffles.
__global__ void __launch_bounds__(kScanThreads) scan_tiles(unsigned* tile_roots, long long tiles) {
  __shared__ unsigned s_warp[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned carry = 0;
  for (long long r0 = 0; r0 < tiles; r0 += (long long)kScanThreads * 32) {
    const long long lo = r0 + (long long)warp * 1024 + lane;
    unsigned t[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) t[k] = lo + 32 * k < tiles ? tile_roots[lo + 32 * k] : 0u;
    unsigned run = 0;  // the warp's totals before this load
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      unsigned inc = t[k];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      const unsigned row = __shfl_sync(kFull, inc, 31);
      t[k] = run + inc - t[k];
      run += row;
    }
    if (lane == 0) s_warp[warp] = run;
    __syncthreads();
    if (warp == 0) {
      const unsigned w = s_warp[lane];
      unsigned wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, wi, o);
        if (lane >= o) wi += y;
      }
      s_warp[lane] = wi;  // inclusive over warps
    }
    __syncthreads();
    const unsigned off = carry + (warp ? s_warp[warp - 1] : 0u);
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (lo + 32 * k < tiles) tile_roots[lo + 32 * k] = off + t[k];
    carry += s_warp[kScanThreads / 32 - 1];
    __syncthreads();  // s_warp is rewritten by the next round
  }
}

// roots at flat indices < g, and at indices <= g (mod 2^32)
__device__ __forceinline__ unsigned roots_before(const uint2* __restrict__ words,
    const unsigned* __restrict__ tile_roots, long long g) {
  const uint2 e = __ldg(words + (g >> 5));
  return __ldg(tile_roots + (g >> kTileShift)) + e.y + __popc(e.x & ((1u << (g & 31)) - 1u));
}

__device__ __forceinline__ unsigned roots_through(const uint2* __restrict__ words,
    const unsigned* __restrict__ tile_roots, long long g) {
  const uint2 e = __ldg(words + (g >> 5));
  return __ldg(tile_roots + (g >> kTileShift)) + e.y + __popc(e.x & ((2u << (g & 31)) - 1u));
}

// seg of a pixel of the plane starting at flat index s whose label is r
// (base: the roots before s)
__device__ __forceinline__ int rank_of(const uint2* __restrict__ words,
                                       const unsigned* __restrict__ tile_roots, long long s,
                                       int r, unsigned plane, unsigned base) {
  if (r < 0) return 0;
  const unsigned q = (unsigned)r < plane ? (unsigned)r : plane - 1;
  return (int)(roots_through(words, tile_roots, s + q) - base);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) compact_ranks(
    const int* __restrict__ raw, const uint2* __restrict__ words,
    const unsigned* __restrict__ tile_roots, int* __restrict__ seg, int* __restrict__ num,
    long long n, unsigned plane) {
  const long long g0 = (long long)blockIdx.x * kChunk;
  const unsigned pstart = (unsigned)(g0 % plane);
  int4 v[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) v[j] = load4<kVec>(raw, g0 + j * kStride + 4 * threadIdx.x, n);
  long long start = -1;  // the plane start whose prefix `base` holds
  unsigned base = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const unsigned off = j * kStride + 4 * threadIdx.x;
    const long long g = g0 + off;
    int r[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    const unsigned p0 = in_plane(pstart, off, plane);
    if (g + 4 <= n && p0 + 3 < plane) {  // the four pixels in one plane: nearly always
      const long long s = g - p0;
      if (s != start) {
        start = s;
        base = roots_before(words, tile_roots, s);
      }
      if (p0 + 3 == plane - 1)
        num[s / plane] = (int)(roots_through(words, tile_roots, s + plane - 1) - base);
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = rank_of(words, tile_roots, s, r[k], plane, base);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (g + k >= n) {
          r[k] = 0;
          continue;
        }
        const unsigned p = in_plane(pstart, off + k, plane);
        const long long s = g + k - p;
        if (s != start) {
          start = s;
          base = roots_before(words, tile_roots, s);
        }
        if (p == plane - 1) num[s / plane] = (int)(roots_through(words, tile_roots, s + p) - base);
        r[k] = rank_of(words, tile_roots, s, r[k], plane, base);
      }
    }
    if (kVec && g + 4 <= n) {
      *reinterpret_cast<int4*>(seg + g) = make_int4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (g + k < n) seg[g + k] = r[k];
    }
  }
}

long long words_of(long long n) { return (n + 31) / 32; }
long long tiles_of(long long n) { return (n + kChunk - 1) / kChunk; }

template <bool kVec>
int launch(const int* raw, int* seg, int* num, uint2* words, unsigned* tile_roots,
           long long n, long long plane, cudaStream_t s) {
  const long long tiles = tiles_of(n);
  compact_bits<kVec><<<(unsigned)tiles, kThreads, 0, s>>>(raw, words, tile_roots, n,
                                                          words_of(n), (unsigned)plane);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles<<<1, kScanThreads, 0, s>>>(tile_roots, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_ranks<kVec><<<(unsigned)tiles, kThreads, 0, s>>>(raw, words, tile_roots, seg, num, n,
                                                           (unsigned)plane);
  return (int)cudaGetLastError();
}

}  // namespace

// int64 scratch elements the wrapper must provide: one {bits, roots before}
// entry a 32-px word, then one 32-bit root count a 4096-px tile.
extern "C" long long pcis_compact_scratch_len(int B, int H, int W) {
  const long long n = (long long)B * H * W;
  return words_of(n) + (tiles_of(n) + 1) / 2;
}

extern "C" int pcis_compact(const void* raw, void* seg, void* num, void* scratch,
                            long long scratch_len, int B, int H, int W, void* stream) {
  const long long plane = (long long)H * W;
  const long long n = B * plane;
  if (B <= 0 || H <= 0 || W <= 0 || plane >= (1ll << 31) || tiles_of(n) >= (1ll << 31) ||
      scratch_len < pcis_compact_scratch_len(B, H, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint2* words = (uint2*)scratch;
  unsigned* tile_roots = (unsigned*)((unsigned long long*)scratch + words_of(n));
  const bool vec = ((uintptr_t)raw | (uintptr_t)seg) % 16 == 0;
  if (vec)
    return launch<true>((const int*)raw, (int*)seg, (int*)num, words, tile_roots, n, plane, s);
  return launch<false>((const int*)raw, (int*)seg, (int*)num, words, tile_roots, n, plane, s);
}
