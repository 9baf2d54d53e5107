// Capped squared EDT device code shared by K9 (edt.cu) and K8 (fill.cu).
//
// The transform (the same function as ops/edt.py's plain edt_sq):
//   dh(r, c) = min(distance to the nearest feature pixel in row r, cap+1)
//   d2(r, c) = min(min over |dy| <= cap of dh(r+dy, c)^2 + dy^2, (cap+1)^2)
// with rows outside the plane featureless.  Exact wherever the true
// distance is <= cap, in (cap^2, (cap+1)^2] past it.
//
// Two pieces live here:
//   - the window loader of the one-kernel routes (K9's edt_tile, K8's
//     fused_fill): 16-byte chunks of a uint8 plane and the byte compares
//     that turn them into mask bits;
//   - the two-kernel route that both take past their one-kernel route's
//     cap (K8's window no longer fits shared memory there, K9's 16-bit sums
//     no longer hold), which works for any H, W >= 1 and any cap through
//     one int32 scratch plane:
//   row_pass  one warp per row: a __ballot_sync of 32 feature bits per step
//             and a carried last/next feature column give the exact row
//             distance in O(1) per pixel, forward then backward;
//   col_tile  a block owns a 64-row x 32-column output tile and walks the
//             source rows [r0-cap, r0+64+cap) in 64-row chunks staged in
//             8 KB of shared memory; each thread keeps 8 output rows in
//             registers and adds exactly the 2*cap+1 taps in reach (the
//             loop bounds are uniform across a warp).
// Everything is in an anonymous namespace, so each translation unit that
// includes this header gets its own kernels.

#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace edt {

constexpr int kRowWarps = 8;          // rows per block in row_pass
constexpr int kTileW = 32;            // output columns per block (one warp)
constexpr int kWarps = 8;             // warps per col_tile block
constexpr int kRowsPerThread = 8;     // output rows each thread keeps
constexpr int kTileH = kWarps * kRowsPerThread;  // 64 output rows per block
constexpr int kChunk = 64;            // source rows staged per step
constexpr unsigned kFull = 0xffffffffu;
// 227 KB a block on sm_90, less 1 KB for a kernel's static shared memory
constexpr size_t kSmemLimit = 232448 - 1024;

// Bit b: byte b of the 16 equals the byte repeated in pat.
__device__ __forceinline__ unsigned byte_mask(const uint4& q, unsigned pat) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // the low bits of the four bytes, gathered into bits 24-27
    const unsigned x = __vcmpeq4(w[i], pat) & 0x01010101u;
    m |= (x * 0x01020408u) >> 24 << (4 * i);
  }
  return m;
}

// 16 bytes of row gr from column gc, and the mask of those inside the plane
// (the rest read 0).  vec: W % 16 == 0 and a 16-byte aligned plane, so a
// chunk lies wholly inside or outside.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ src, int gr, int gc,
                                            int H, int W, bool vec, unsigned& inside) {
  inside = 0;
  if (gr < 0 || gr >= H) return make_uint4(0, 0, 0, 0);
  const uint8_t* row = src + (long long)gr * W;
  if (vec) {
    if (gc < 0 || gc >= W) return make_uint4(0, 0, 0, 0);
    inside = 0xffffu;
    return __ldg(reinterpret_cast<const uint4*>(row + gc));
  }
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (gc + b >= 0 && gc + b < W) {
      w[b >> 2] |= (unsigned)row[gc + b] << (8 * (b & 3));
      inside |= 1u << b;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ bool is_feature(uint8_t v, int match) {
  return match < 0 ? v != 0 : (int)v == match;
}

// dh^2 of every pixel of `nrows` rows of width W.  Feature: value != 0 when
// match < 0, value == match otherwise.  Launch with kRowWarps*32 threads.
__global__ void row_pass(const uint8_t* __restrict__ img, int* __restrict__ dh2,
                         long long nrows, int W, int cap, int match) {
  const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= nrows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const uint8_t* f = img + row * W;
  int* o = dh2 + row * W;
  const int c1 = cap + 1;
  int last = -1;  // column of the last feature left of this chunk, -1 none
  for (int base = 0; base < W; base += 32) {
    const int x = base + lane;
    const unsigned m = __ballot_sync(0xffffffffu, x < W && is_feature(f[x], match));
    const unsigned upto = m & (0xffffffffu >> (31 - lane));  // bits 0..lane
    const int left = upto ? base + 31 - __clz(upto) : last;
    if (x < W) o[x] = left < 0 ? c1 : min(x - left, c1);
    if (m) last = base + 31 - __clz(m);
  }
  int next = -1;  // column of the first feature right of this chunk, -1 none
  for (int base = (W - 1) & ~31; base >= 0; base -= 32) {
    const int x = base + lane;
    const unsigned m = __ballot_sync(0xffffffffu, x < W && is_feature(f[x], match));
    const unsigned from = m & (0xffffffffu << lane);  // bits lane..31
    const int right = from ? base + __ffs(from) - 1 : next;
    if (x < W) {
      int d = o[x];
      if (right >= 0) d = min(d, right - x);
      o[x] = d * d;
    }
    if (m) next = base + __ffs(m) - 1;
  }
}

// Column min-plus over the tile (blockIdx.x, blockIdx.y) of one plane's dh2:
// calls epi(r, c, d2) once for every output pixel of the tile inside the
// plane.  Launch with kWarps*32 threads, grid (ceil(W/32), ceil(H/64), B).
template <class Epi>
__device__ __forceinline__ void col_tile(const int* __restrict__ dh2, int H, int W,
                                         int cap, Epi& epi) {
  __shared__ int s[kChunk][kTileW];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * kTileW + tx;
  const int r0 = blockIdx.y * kTileH;
  const int o0 = r0 + ty * kRowsPerThread;
  const int inf = (cap + 1) * (cap + 1);
  int acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = inf;
  const int lo = max(r0 - cap, 0);
  const int hi = min(r0 + kTileH + cap, H);  // source rows [lo, hi)
  for (int s0 = lo; s0 < hi; s0 += kChunk) {
    for (int k = ty; k < kChunk; k += kWarps) {
      const int sr = s0 + k;
      s[k][tx] = (sr < hi && c < W) ? dh2[(long long)sr * W + c] : inf;
    }
    __syncthreads();
    const int s_last = min(s0 + kChunk, hi) - 1;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int o = o0 + i;
      const int k_hi = min(o + cap, s_last) - s0;
      int a = acc[i];
      for (int k = max(o - cap, s0) - s0; k <= k_hi; ++k) {
        const int dy = s0 + k - o;
        a = min(a, s[k][tx] + dy * dy);
      }
      acc[i] = a;
    }
    __syncthreads();
  }
  if (c < W) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      if (o0 + i < H) epi(o0 + i, c, acc[i]);
  }
}

inline dim3 row_grid(long long nrows) {
  return dim3((unsigned)((nrows + kRowWarps - 1) / kRowWarps));
}

inline dim3 tile_grid(int B, int H, int W) {
  return dim3((unsigned)((W + kTileW - 1) / kTileW),
              (unsigned)((H + kTileH - 1) / kTileH), (unsigned)B);
}

// Let `kernel` take `bytes` of dynamic shared memory, once a process for
// each device (`ready` holds a bit a device, owned by the caller).
inline cudaError_t allow_smem(const void* kernel, size_t bytes,
                              std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) ready.fetch_or(bit);
  return e;
}

// The entry points' shared argument check.
inline bool bad_shape(int B, int H, int W, int cap) {
  return B <= 0 || B > 65535 || H <= 0 || W <= 0 ||
         (long long)H * W >= (1ll << 31) || cap < 0 || cap > 32766 ||
         (H + kTileH - 1) / kTileH > 65535;
}

}  // namespace edt
}  // namespace
