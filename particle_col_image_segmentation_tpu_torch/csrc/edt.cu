// K9: capped squared Euclidean distance transform.
//
// Replaces: particle_col_image_segmentation_tpu/ops/edt_tiles.py
//   _edt_kernel (launched by edt_sq_pallas, dispatched by edt_sq_auto).
//
// Contract (same as ops.edt.edt_sq): out[b, r, c] = squared distance from
// (r, c) to the nearest nonzero pixel of feat[b], exact where that distance
// is <= cap and in (cap^2, (cap+1)^2] past it; any H, W >= 1 and 0 <= cap <= 32766
// (cap > H included).  The JAX dispatch used its kernel only for cap > 8 on
// lane-aligned planes; this one serves every cap, so disk dilation (cap 2)
// rides it too.  With a flag, it also writes 1 there if some d2 > cap^2
// (the exact transform's certificate, ops/edt_tiles.py), else 0, over the
// rows [flag_lo, flag_hi) of each plane only: a row band of a plane split
// over a mesh is transformed with cap halo rows above and below it, whose
// own distances (rows past the plane's edge are featureless) mean nothing,
// so only the band's own rows may raise its flag.
//
// Bound on this card: memory, 1 B read and 4 B written a pixel.  The
// capped transform needs no feature further than cap columns or cap rows
// away, so an output tile's whole input is a window of its 1-byte features
// with a cap-wide halo.  Two routes, chosen by cap alone:
//
// edt_tile, for every cap up to pcis_edt_max_tile_cap(), 180 (the analyze
// path's cap is 2, refine's probe 32): one kernel, no scratch plane.  A
// 256-thread block owns a 128 x 128 output tile and
//   1. reads its window once: rows [r0 - cap, r0 + 128 + cap) over the
//      32-column words within 32 * ceil(cap / 32) of the tile, in 16-byte
//      chunks (edt.cuh's loader, as K8's), into one feature bit a pixel;
//   2. takes every window row's capped distance dh over the tile's columns,
//      a thread a row and word: the distance to the nearest feature left and
//      right of the word by __clz / __ffs on at most ceil(cap / 32) words
//      each way, then one sweep each way over its 32 bits that carries the
//      capped distance (a bit test, an add and a min a pixel, no search);
//      dh^2 is kept as 16-bit pairs in shared memory;
//   3. takes each output pixel's column min-plus over the rows r +- dy,
//      a thread two pixel pairs, both halves of a pair in one instruction
//      (Hopper's __viaddmin_u16x2: min(a + b, c) a halfword), from dy = 1
//      outward while dy^2 is below the best sum of some pixel of the warp
//      (no farther row can beat it), so a pixel costs about 2 * min(d, cap)
//      + 1 taps, not 2 * cap + 1 (up to cap 2, every tap without a vote);
//      each warp writes 64 consecutive int32 at a time.
// 16 bits hold every sum while (cap + 1)^2 + cap^2 < 2^16, which sets the
// route's cap limit; the window fits shared memory past it.
//
// two-kernel route, for larger caps (edt.cuh, shared with K8): the ballot
// row pass into an int32 scratch plane, then 64 x 32 column tiles that add
// all 2 * cap + 1 taps a pixel.

#include "edt.cuh"

namespace {

constexpr int kOutH = 128;     // output rows a block
constexpr int kOutW = 128;     // output columns a block
constexpr int kWords = kOutW / 32;
constexpr int kThreads = 256;
constexpr int kBatch = 4;      // window chunks a thread loads at once
constexpr int kSeg = 17;       // a word's 16 pixel pairs in shared memory, padded
constexpr int kPairRow = kWords * kSeg;
using edt::kFull;

// A block's window: rows [r0 - cap, r0 + 128 + cap), 32-column words
// [c0 - 32 e, c0 + 128 + 32 e), e = ceil(cap / 32).  Its shared memory: the
// feature bits [rows][words], then dh^2 as 16-bit pairs [rows][4][17].
__host__ __device__ constexpr int tile_words(int cap) { return kWords + 2 * ((cap + 31) / 32); }
__host__ __device__ constexpr size_t tile_smem(int cap) {
  return (size_t)(kOutH + 2 * cap) * (tile_words(cap) + kPairRow) * 4;
}
// the largest cap whose window fits shared memory and whose sums
// dh^2 + dy^2 <= (cap + 1)^2 + cap^2 fit 16 bits
constexpr int max_tile_cap() {
  int cap = 0;
  while (tile_smem(cap + 1) <= edt::kSmemLimit && (cap + 2) * (cap + 2) + (cap + 1) * (cap + 1) <= 65535)
    ++cap;
  return cap;
}
constexpr int kMaxTileCap = max_tile_cap();

// grid (ceil(W / 128), ceil(H / 128), B), 256 threads.  vec: W % 16 == 0
// and a 16-byte aligned batch (16-byte window loads); vec2: 8-byte stores
// of pixel pairs (W even, out 8-byte aligned).
__global__ void __launch_bounds__(kThreads, 5) edt_tile(const uint8_t* __restrict__ feat,
                                                     int* __restrict__ out, int* __restrict__ flag,
                                                     int H, int W, int cap, bool vec, bool vec2,
                                                     int flag_lo, int flag_hi) {
  extern __shared__ __align__(16) unsigned smem[];
  const int e = (cap + 31) / 32, nw = tile_words(cap), nu = 2 * nw;
  const int rows = kOutH + 2 * cap, c1 = cap + 1;
  unsigned* bits = smem;                 // [rows][nw]
  unsigned* pairs = smem + rows * nw;    // [rows][kWords][kSeg]: dh^2 lo | hi << 16
  const int r0 = blockIdx.y * kOutH, c0 = blockIdx.x * kOutW;
  const long long off = (long long)blockIdx.z * H * W;
  // 1. the window's feature bits.  Thread (k0, u) loads chunk u of window
  // rows k0, k0 + ks, ...; every thread runs the same rounds (the pairs of
  // lanes shuffle), and an even u (an even thread) joins chunk u + 1's bits.
  const int ks = kThreads / nu, u = threadIdx.x % nu, k0 = threadIdx.x / nu;
  for (int base = k0; base < rows + k0; base += kBatch * ks) {
    uint4 q[kBatch];
    unsigned inside[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {  // the loads first, all in flight
      const int k = base + t * ks;
      inside[t] = 0;
      q[t] = k0 < ks && k < rows
                 ? edt::load_chunk(feat + off, r0 - cap + k, c0 - 32 * e + 16 * u, H, W, vec,
                                   inside[t])
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int k = base + t * ks;
      const unsigned fb = ~edt::byte_mask(q[t], 0u) & inside[t];  // nonzero bytes
      const unsigned hi = __shfl_down_sync(kFull, fb, 1);
      if (k0 < ks && k < rows && !(u & 1)) bits[k * nw + (u >> 1)] = fb | hi << 16;
    }
  }
  __syncthreads();
  // 2. dh^2 of every window row over the tile's columns, a thread a row and
  // word: the nearest feature left and right of the word (__clz, __ffs on
  // at most e words each way), then one sweep each way over its 32 bits
  for (int i = threadIdx.x; i < rows * kWords; i += kThreads) {
    const int k = i / kWords, w = i % kWords, wi = e + w;
    const unsigned* row = bits + k * nw;
    const unsigned x = row[wi];
    // capped distances of the pixels just left of bit 0 and just right of
    // bit 31 to their nearest feature at or beyond them
    int dl = c1, dr = c1;
    for (int t = 1; t <= e; ++t) {
      const unsigned y = row[wi - t];
      if (y) {
        dl = min(32 * t - 32 + __clz(y), c1);
        break;
      }
    }
    for (int t = 1; t <= e; ++t) {
      const unsigned y = row[wi + t];
      if (y) {
        dr = min(32 * t - 32 + __ffs(y) - 1, c1);
        break;
      }
    }
    int right[32];  // capped distance to the nearest feature at or right of each bit
#pragma unroll
    for (int b = 31; b >= 0; --b) {
      dr = x >> b & 1 ? 0 : min(dr + 1, c1);
      right[b] = dr;
    }
    unsigned* dst = pairs + k * kPairRow + w * kSeg;
#pragma unroll
    for (int b = 0; b < 32; b += 2) {
      dl = x >> b & 1 ? 0 : min(dl + 1, c1);
      const int d0 = min(dl, right[b]);
      dl = x >> (b + 1) & 1 ? 0 : min(dl + 1, c1);
      const int d1 = min(dl, right[b + 1]);
      dst[b >> 1] = (unsigned)(d0 * d0) | (unsigned)(d1 * d1) << 16;
    }
  }
  __syncthreads();
  // 3. the column min-plus, a thread two pixel pairs (rows o and o + 64; a
  // warp 64 columns of each), both halves of a pair in one 16-bit min.
  // dh^2 <= (cap + 1)^2 already, so no clamp is needed.
  bool deep = false;
  const int cap2 = cap * cap;
  int* dst = out + off;
  constexpr int kHalf = kOutH * (kOutW / 2) / 2;  // pairs in half a tile
  for (int i0 = threadIdx.x; i0 < kHalf; i0 += kThreads) {
    unsigned best[2];
    const unsigned* col[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = (i0 + h * kHalf) / (kOutW / 2), p = (i0 + h * kHalf) % (kOutW / 2);
      col[h] = pairs + (o + cap) * kPairRow + (p >> 4) * kSeg + (p & 15);
      best[h] = col[h][0];
    }
    auto taps = [&](int dy, unsigned q) {  // rows r +- dy, q = dy^2 in both halves
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        best[h] = __viaddmin_u16x2(col[h][-dy * kPairRow], q, best[h]);
        best[h] = __viaddmin_u16x2(col[h][dy * kPairRow], q, best[h]);
      }
    };
    if (cap <= 2) {  // every tap, unrolled: a vote would cost more than it saves
#pragma unroll
      for (int dy = 1; dy <= 2; ++dy)
        if (dy <= cap) taps(dy, (unsigned)(dy * dy) * 0x10001u);
    } else {
      // outward while some pixel of the warp can still gain: dy^2 < its
      // best (the vote is uniform across the warp)
      for (int dy = 1; dy <= cap; ++dy) {
        const unsigned q = (unsigned)(dy * dy) * 0x10001u;
        if (!__any_sync(kFull, __vsetltu2(q, best[0]) | __vsetltu2(q, best[1]))) break;
        taps(dy, q);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = (i0 + h * kHalf) / (kOutW / 2), p = (i0 + h * kHalf) % (kOutW / 2);
      const int r = r0 + o, c = c0 + 2 * p;
      if (r >= H || c >= W) continue;
      const int d0 = (int)(best[h] & 0xffffu), d1 = (int)(best[h] >> 16);
      int* px = dst + (long long)r * W + c;
      const bool counted = r >= flag_lo && r < flag_hi;
      if (c + 1 >= W) {
        *px = d0;
        deep |= counted && d0 > cap2;
        continue;
      }
      if (vec2) {
        *reinterpret_cast<int2*>(px) = make_int2(d0, d1);
      } else {
        px[0] = d0;
        px[1] = d1;
      }
      deep |= counted && max(d0, d1) > cap2;
    }
  }
  if (flag != nullptr && __syncthreads_or(deep) && threadIdx.x == 0) *flag = 1;
}

__global__ void edt_store(const int* __restrict__ dh2, int* __restrict__ out,
                          int* __restrict__ flag, int H, int W, int cap, int flag_lo,
                          int flag_hi) {
  const long long off = (long long)blockIdx.z * H * W;
  int* dst = out + off;
  bool deep = false;
  const int cap2 = cap * cap;
  auto store = [&](int r, int c, int d2) {
    dst[(long long)r * W + c] = d2;
    deep |= r >= flag_lo && r < flag_hi && d2 > cap2;
  };
  edt::col_tile(dh2 + off, H, W, cap, store);
  if (flag != nullptr && __syncthreads_or(deep) && threadIdx.x == 0) *flag = 1;
}

}  // namespace

// The largest cap the one-kernel route takes; larger caps take the
// two-kernel route, which needs the scratch plane.
extern "C" int pcis_edt_max_tile_cap() { return kMaxTileCap; }

// scratch: int32 [B, H, W], read only past pcis_edt_max_tile_cap() (may be
// null below it).  flag: one int32, or null for none, raised by the rows
// [flag_lo, flag_hi) of each plane (0, H for a whole plane).
extern "C" int pcis_edt_sq(const void* feat, void* out, void* scratch, void* flag, int B,
                           int H, int W, int cap, int flag_lo, int flag_hi, void* stream) {
  if (edt::bad_shape(B, H, W, cap) || (cap > kMaxTileCap && scratch == nullptr) ||
      flag_lo < 0 || flag_lo > flag_hi || flag_hi > H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (flag != nullptr) {
    e = cudaMemsetAsync(flag, 0, sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (cap <= kMaxTileCap) {
    static std::atomic<unsigned long long> ready{0};
    e = edt::allow_smem((const void*)edt_tile, tile_smem(kMaxTileCap), ready);
    if (e != cudaSuccess) return (int)e;
    const bool vec = W % 16 == 0 && (uintptr_t)feat % 16 == 0;
    const bool vec2 = W % 2 == 0 && (uintptr_t)out % 8 == 0;
    const dim3 grid((unsigned)((W + kOutW - 1) / kOutW), (unsigned)((H + kOutH - 1) / kOutH),
                    (unsigned)B);
    edt_tile<<<grid, kThreads, tile_smem(cap), s>>>((const uint8_t*)feat, (int*)out,
                                                     (int*)flag, H, W, cap, vec, vec2, flag_lo,
                                                     flag_hi);
    return (int)cudaGetLastError();
  }
  const long long nrows = (long long)B * H;
  int* dh2 = (int*)scratch;
  edt::row_pass<<<edt::row_grid(nrows), edt::kRowWarps * 32, 0, s>>>(
      (const uint8_t*)feat, dh2, nrows, W, cap, -1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  edt_store<<<edt::tile_grid(B, H, W), edt::kWarps * 32, 0, s>>>(
      dh2, (int*)out, (int*)flag, H, W, cap, flag_lo, flag_hi);
  return (int)cudaGetLastError();
}
