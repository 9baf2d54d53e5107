// K8: one strain's particle-fill step.
//
// Replaces: particle_col_image_segmentation_tpu/ops/fill_tiles.py
//   _fill_kernel (launched by particle_fill_step_pallas, dispatched by
//   particle_fill_step_auto).
//
// Contract (same as ops.fill_tiles.particle_fill_step): with d2 the capped
// squared EDT of the particle mask (img == pval, edt.cuh),
//   overlap = img == sval && (d2 < dt2 || d2 <= dr2)
//   out     = overlap ? pval : img          (a fresh plane: Jacobi)
//   count[b] = #overlap pixels of plane b in rows [count_lo, count_hi)
//
// The count's row window serves a plane split into row bands over a mesh:
// a band is filled with `cap` halo rows above and below it (its neighbours'
// rows, or rows of a value that is neither pval nor sval past the plane's
// edges), and only its own rows count.  A whole plane passes [0, H).
//
// Bound on this card: memory, one uint8 read and one uint8 write a pixel.
// Two routes, chosen by the caller from cap alone (pcis_fill_max_fused_cap):
//
// fused_fill, for every cap whose window fits shared memory (the analyze
// cap is 20): one kernel, no scratch plane.  A 256-thread block owns a
// 64 x 128 output tile.  It reads its window once: the rows within cap of
// the tile, over the 32-column words within 32 * ceil(cap / 32) of it, in
// 16-byte chunks (16-byte loads where W % 16 == 0, else bytes), four chunks
// a thread in flight.  It keeps the tile's own bytes and one bit a pixel of
// the particle mask (byte compares, __vcmpeq4) in shared memory.  Then:
//   - the fill test needs no distance: with T = max(dt2 - 1, dr2), overlap
//     is img == sval && d2 <= T.  If T >= (cap + 1)^2 every sval pixel
//     fills.  Otherwise a pixel fills exactly where a particle pixel lies at
//     row offset dv and column offset dh with dv^2 + dh^2 <= T (both are
//     then <= cap), i.e. where some window row r +- dv, dilated along the
//     row by w(dv) = isqrt(T - dv^2), has its bit set;
//   - so a tile that has no sval pixel, or (when T < (cap + 1)^2) no
//     particle pixel in its window, writes its bytes back unchanged and
//     counts nothing;
//   - otherwise the block walks dv from isqrt(T) down to 0.  w(dv) only
//     grows on that walk, so every window row's mask is dilated by one
//     column at a time in place of distances (a funnel shift each way, a
//     word a thread, two buffers), isqrt(T) steps in all, and each thread
//     ORs the two dilated rows r +- dv into the 32 cover bits it owns (an
//     output row and word): 2 * isqrt(T) + 2 shared loads for 32 pixels,
//     in place of 2 * cap + 1 taps a pixel;
//   - each thread then fills its 32 bytes four at a time (the sval bytes
//     under cover bits), sums its count (warp reduce, one shared atomic a
//     warp), and the block adds it to count[b] with one device atomic.
//
// two-kernel route, for larger caps: the route K9 also takes past its own
// one-kernel route (edt.cuh: the ballot row pass into an int32 scratch
// plane, then 64 x 32 column tiles) with the fill test as the column pass's
// epilogue.

#include <atomic>

#include "edt.cuh"

namespace {

constexpr int kFillH = 64;        // output rows a fused block
constexpr int kFillW = 128;       // output columns a fused block
constexpr int kFillThreads = 256; // a thread an output row and 32-column word
constexpr int kBatch = 4;         // window chunks a thread loads at once
using edt::byte_mask;
using edt::kFull;
using edt::kSmemLimit;
using edt::load_chunk;

// A fused block's window: rows [r0 - cap, r0 + 64 + cap) and the 32-column
// words [c0 - 32 e, c0 + 128 + 32 e), e = ceil(cap / 32).  Its shared
// memory: the tile's bytes, then two buffers of mask words.
__host__ __device__ constexpr int fused_words(int cap) { return kFillW / 32 + 2 * ((cap + 31) / 32); }
__host__ __device__ constexpr size_t fused_smem(int cap) {
  return kFillH * kFillW + 2 * (size_t)(kFillH + 2 * cap) * fused_words(cap) * 4;
}
constexpr int max_fused_cap() {
  int cap = 0;
  while (fused_smem(cap + 1) <= kSmemLimit) ++cap;
  return cap;
}
constexpr int kMaxFusedCap = max_fused_cap();

__device__ __forceinline__ int isqrt(int v) {
  int h = (int)sqrtf((float)v);
  while (h * h > v) --h;
  while ((h + 1) * (h + 1) <= v) ++h;
  return h;
}

// grid (ceil(W / 128), ceil(H / 64), B), 256 threads.  T: the fill
// threshold on d2 (-1: none), or any when fill_all (T >= (cap + 1)^2).
__global__ void __launch_bounds__(kFillThreads) fused_fill(
    const uint8_t* __restrict__ img, uint8_t* __restrict__ out, int* __restrict__ count,
    int H, int W, int cap, int pval, int sval, int T, bool fill_all, bool vec, int count_lo,
    int count_hi) {
  extern __shared__ __align__(16) uint4 tile16[];  // the tile: [64][8] chunks
  __shared__ int s_count;
  uint8_t* tile = reinterpret_cast<uint8_t*>(tile16);
  const int e = (cap + 31) / 32, nw = fused_words(cap), nu = 2 * nw;
  const int rows = kFillH + 2 * cap;
  unsigned* cur = reinterpret_cast<unsigned*>(tile + kFillH * kFillW);  // [rows][nw]
  unsigned* nxt = cur + rows * nw;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * kFillH, c0 = blockIdx.x * kFillW;
  const long long off = (long long)blockIdx.z * H * W;
  const uint8_t* src = img + off;
  if (threadIdx.x == 0) s_count = 0;
  // the window, read once: mask words, and the tile's own bytes.  Thread
  // (k0, u) loads chunk u of window rows k0, k0 + ks, ...; every thread runs
  // the same rounds (the pairs of lanes shuffle).
  const unsigned pp = 0x01010101u * pval, ss = 0x01010101u * sval;
  const int ks = kFillThreads / nu, u = threadIdx.x % nu, k0 = threadIdx.x / nu;
  const bool in_tile_cols = u >= 2 * e && u < 2 * e + kFillW / 16;
  bool any_p = false, any_s = false;
  for (int base = k0; base < rows + k0; base += kBatch * ks) {
    uint4 q[kBatch];
    unsigned inside[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {  // the loads first, all in flight
      const int k = base + t * ks;
      inside[t] = 0;
      q[t] = k0 < ks && k < rows
                 ? load_chunk(src, r0 - cap + k, c0 - 32 * e + 16 * u, H, W, vec, inside[t])
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int k = base + t * ks;
      const bool mine = k0 < ks && k < rows;
      const unsigned pb = byte_mask(q[t], pp) & inside[t];
      any_p |= pb != 0;
      if (mine && in_tile_cols && k >= cap && k < cap + kFillH) {
        tile16[(k - cap) * (kFillW / 16) + u - 2 * e] = q[t];
        any_s |= (byte_mask(q[t], ss) & inside[t]) != 0;
      }
      const unsigned hi = __shfl_down_sync(kFull, pb, 1);  // chunk u + 1's bits
      if (mine && !(u & 1)) cur[k * nw + (u >> 1)] = pb | hi << 16;
    }
  }
  any_p = __syncthreads_or(any_p);
  any_s = __syncthreads_or(any_s);
  uint8_t* dst = out + off;
  if (any_s && (fill_all || (any_p && T >= 0))) {
    const int o = threadIdx.x >> 2, qw = threadIdx.x & 3;  // output row, word
    unsigned acc = ~0u;  // cover bits of columns c0 + 32 qw + [0, 32)
    if (!fill_all) {
      acc = 0;
      // the dilation's threads: word x of rows j0, j0 + js, ...
      const int js = kFillThreads / nw, x = threadIdx.x % nw, j0 = threadIdx.x / nw;
      int level = 0;  // cur holds every row dilated by `level` columns
      for (int dv = isqrt(T); dv >= 0; --dv) {
        // up to w(dv) = isqrt(T - dv^2), one column a step
        for (const int t2 = T - dv * dv; (level + 1) * (level + 1) <= t2; ++level) {
          if (j0 < js) {
            for (int k = j0; k < rows; k += js) {
              const unsigned* row = cur + k * nw;
              const unsigned a = row[x];
              const unsigned lo = x > 0 ? row[x - 1] : 0u, hi = x + 1 < nw ? row[x + 1] : 0u;
              nxt[k * nw + x] = a | __funnelshift_l(lo, a, 1) | __funnelshift_r(a, hi, 1);
            }
          }
          unsigned* t = cur;
          cur = nxt;
          nxt = t;
          // cur's readers before this step read the buffer it was written
          // from, so one barrier a step suffices
          __syncthreads();
        }
        const int k = o + cap;  // the output row's window row
        acc |= cur[(k - dv) * nw + e + qw] | cur[(k + dv) * nw + e + qw];
      }
    }
    // only pixels inside the plane fill
    const int cw = W - (c0 + 32 * qw);
    if (r0 + o >= H || cw <= 0) acc = 0;
    else if (cw < 32) acc &= (1u << cw) - 1;
    uint4* mine = tile16 + o * (kFillW / 16) + 2 * qw;
    const bool counted = r0 + o >= count_lo && r0 + o < count_hi;
    int n = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = mine[h];
      unsigned wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // the 4 cover bits of these bytes, spread to byte masks
        const unsigned nib = (acc >> (16 * h + 4 * i)) & 0xfu;
        const unsigned m = __vcmpeq4(wv[i], ss) & (((nib * 0x00204081u) & 0x01010101u) * 0xffu);
        wv[i] = (wv[i] & ~m) | (pp & m);
        if (counted) n += __popc(m) >> 3;
      }
      mine[h] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
    n = __reduce_add_sync(kFull, n);
    if (lane == 0 && n) atomicAdd(&s_count, n);
    __syncthreads();
  }
  // the tile back out, 16-byte chunks
  for (int i = threadIdx.x; i < kFillH * kFillW / 16; i += kFillThreads) {
    const int o = i / (kFillW / 16), gc = c0 + 16 * (i % (kFillW / 16));
    if (r0 + o >= H || gc >= W) continue;
    uint8_t* d = dst + (long long)(r0 + o) * W + gc;
    if (vec) {
      *reinterpret_cast<uint4*>(d) = tile16[i];
    } else {
      for (int b = 0; b < 16 && gc + b < W; ++b) d[b] = tile[16 * i + b];
    }
  }
  if (threadIdx.x == 0 && s_count) atomicAdd(&count[blockIdx.z], s_count);
}

__global__ void fill_tile(const int* __restrict__ dh2, const uint8_t* __restrict__ img,
                          uint8_t* __restrict__ out, int* __restrict__ count,
                          int H, int W, int cap, int pval, int sval, int dt2,
                          int dr2, int count_lo, int count_hi) {
  __shared__ int s_count;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const long long off = (long long)blockIdx.z * H * W;
  const uint8_t* src = img + off;
  uint8_t* dst = out + off;
  int n = 0;
  auto fill = [&](int r, int c, int d2) {
    const long long p = (long long)r * W + c;
    const int x = src[p];
    const bool ov = x == sval && (d2 < dt2 || d2 <= dr2);
    dst[p] = (uint8_t)(ov ? pval : x);
    n += ov && r >= count_lo && r < count_hi;
  };
  edt::col_tile(dh2 + off, H, W, cap, fill);
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&s_count, n);
  __syncthreads();
  if (threadIdx.x == 0 && s_count) atomicAdd(&count[blockIdx.z], s_count);
}

bool bad_args(int B, int H, int W, int cap, int pval, int sval) {
  return edt::bad_shape(B, H, W, cap) || pval < 0 || pval > 255 || sval < 0 || sval > 255;
}

}  // namespace

// The largest cap the fused route takes; larger caps take the two-kernel
// route (pcis_particle_fill, with its int32 scratch plane).
extern "C" int pcis_fill_max_fused_cap() { return kMaxFusedCap; }

extern "C" int pcis_particle_fill_fused(const void* img, void* out, void* count, int B, int H,
                                        int W, int cap, int pval, int sval, int dt2, int dr2,
                                        int count_lo, int count_hi, void* stream) {
  if (bad_args(B, H, W, cap, pval, sval) || cap > kMaxFusedCap)
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t e = edt::allow_smem((const void*)fused_fill, fused_smem(kMaxFusedCap), ready);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(count, 0, sizeof(int) * (size_t)B, s);
  if (e != cudaSuccess) return (int)e;
  // d2 < dt2 || d2 <= dr2  <=>  d2 <= max(dt2 - 1, dr2), and d2 <= (cap + 1)^2
  const long long t = (long long)dt2 - 1 > dr2 ? (long long)dt2 - 1 : dr2;
  const bool fill_all = t >= (long long)(cap + 1) * (cap + 1);
  const int T = fill_all ? 0 : (t < 0 ? -1 : (int)t);
  const bool vec = W % 16 == 0 && ((uintptr_t)img | (uintptr_t)out) % 16 == 0;
  const dim3 grid((unsigned)((W + kFillW - 1) / kFillW), (unsigned)((H + kFillH - 1) / kFillH),
                  (unsigned)B);
  fused_fill<<<grid, kFillThreads, fused_smem(cap), s>>>(
      (const uint8_t*)img, (uint8_t*)out, (int*)count, H, W, cap, pval, sval, T, fill_all, vec,
      count_lo, count_hi);
  return (int)cudaGetLastError();
}

extern "C" int pcis_particle_fill(const void* img, void* out, void* count,
                                  void* scratch, int B, int H, int W, int cap,
                                  int pval, int sval, int dt2, int dr2,
                                  int count_lo, int count_hi, void* stream) {
  if (bad_args(B, H, W, cap, pval, sval)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int) * (size_t)B, s);
  if (e != cudaSuccess) return (int)e;
  const long long nrows = (long long)B * H;
  int* dh2 = (int*)scratch;
  edt::row_pass<<<edt::row_grid(nrows), edt::kRowWarps * 32, 0, s>>>(
      (const uint8_t*)img, dh2, nrows, W, cap, pval);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fill_tile<<<edt::tile_grid(B, H, W), edt::kWarps * 32, 0, s>>>(
      dh2, (const uint8_t*)img, (uint8_t*)out, (int*)count, H, W, cap, pval,
      sval, dt2, dr2, count_lo, count_hi);
  return (int)cudaGetLastError();
}
