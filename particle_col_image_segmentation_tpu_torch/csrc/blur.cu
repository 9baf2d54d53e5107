// The Gaussian blur of ops.filters.gaussian_blur, in both of its forms.
//
// Replaces no TPU kernel: particle_col_image_segmentation_tpu/ops/filters.py
// gaussian_blur is left to XLA there.  Config #2 runs the blur under
// jax.jit, whose CPU code contracts each tap's multiply into the add it
// feeds; eager JAX (and NanoSIMS) rounds both.  Plain tensor code can give
// the contracted form only through float64 emulation (ops.rounding.fma_f32,
// some fifteen passes a tap); on this card it is one __fmaf_rn a tap.
//
// Contract (ops.filters.blur_plain, taps k[0..2h], replicate padding):
//   columns first, c[y, x] = S_o in[clamp(y + o - h), x] * k[o]
//   then rows,     out[y, x] = S_o c[y, clamp(x + o - h)] * k[o]
// each S in tap order, float32 between the passes, summed
//   kFma:   acc = fma(v0, k0, v1 * k1), then acc = fma(v_o, k_o, acc), o >= 2
//   !kFma:  acc = v0 * k0,              then acc = acc + v_o * k_o,    o >= 1
// every step rounded to nearest even.  nvcc contracts a*b + c into an FMA
// by default (--fmad=true), so the arithmetic is written only with the
// __fmul_rn / __fadd_rn / __fmaf_rn intrinsics, which it never contracts or
// reorders.  No fast-math: it would flush subnormals.
//
// Bound on this card: memory, 2 B a uint16 pixel read (4 B float32) and
// 4 B a float32 pixel written.  Two routes, chosen by the half-width h
// alone:
//
// h <= kRingMaxHalf (5, σ <= 2.5; config #2's σ 1 and NanoSIMS's σ 1 and
// 1.5 are h 2 and 3): the register ring, blur_ring.  A warp owns a strip
// of 32 x 8 columns and walks down kRows (16) output rows of it; lanes
// 1..30 write 240 columns, lanes 0 and 31 only compute the column sums
// their neighbours need for the row pass.
//   - A lane reads its 8 pixels of a row with one 16-byte load (two for
//     float32), or, where the 8 columns leave the plane, the base is not
//     16-byte aligned or W is not a multiple of the vector width, with 8
//     clamped scalar loads (replicate padding); uint16 converted exactly.
//   - It keeps the last 2h + 1 input rows of its columns in registers (the
//     ring) and loads each row kAhead (4) rows before it enters the ring;
//     the row loop is unrolled by a multiple of 2h + 1, so every ring and
//     prefetch index is a compile-time constant.  Each value read from
//     device memory serves 2h + 1 outputs; an output's column sum is its
//     own chain over the ring, in tap order, with no shared-memory read.
//   - The row pass takes the h column sums on each side from the lanes
//     beside it by warp shuffles and writes 8 outputs with two 16-byte
//     stores (scalar ones at the right edge or for a W not a multiple of 4).
//   - No shared memory, no block barrier; a 1-D grid of two-warp blocks,
//     a warp a (plane, 16-row tile, 240-column tile).
//   Past h = 5 the float32 ring spills registers (ptxas -v), and nothing on
//   the port's paths blurs that wide.
//
// h > kRingMaxHalf, up to kMaxHalf (σ 2.6 to 32): the shared window,
// blur_window.  One block a 32 x 128 tile: the input window with its 2h
// halo rows and columns into shared memory with clamped indices, the
// column pass over its 128 + 2h columns into a second shared buffer, then
// the row pass from it; warps walk rows, lanes columns.
//
// The taps ride in the launch's parameters: no device copy, no host sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHalf = 64;  // ops.blur_tiles.MAX_HALF
constexpr int kMaxTaps = 2 * kMaxHalf + 1;
constexpr unsigned kFull = 0xffffffffu;

struct Taps {
  float k[kMaxTaps];
};

__device__ __forceinline__ int clamp_to(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(unsigned short v) { return __uint2float_rn(v); }

// ---- the register ring (h <= kRingMaxHalf) ----

constexpr int kStrip = 8;                   // columns a lane
constexpr int kTileW = (32 - 2) * kStrip;   // output columns a warp: lanes 1..30
constexpr int kRingMaxHalf = 5;             // the widest ring that does not spill
constexpr int kRows = 16;                   // output rows a warp walks
constexpr int kRingWarps = 2;               // warps a block
constexpr int kAhead = 4;                   // rows loaded ahead of the ring
static_assert(kRingMaxHalf <= kStrip, "a lane's halo must lie in its neighbours' strips");

// 8 pixels of one row, as loaded
struct U16x8 {
  uint4 v;
};
struct F32x8 {
  float4 a, b;
};
template <typename T> struct Pixels;
template <> struct Pixels<unsigned short> { using type = U16x8; };
template <> struct Pixels<float> { using type = F32x8; };

// row[xs .. xs + 8), clamped into [0, W); vec: 16-byte loads are aligned
__device__ __forceinline__ void load8(const unsigned short* row, int xs, int W, bool vec,
                                      U16x8& p) {
  if (vec && xs >= 0 && xs + kStrip <= W) {
    p.v = __ldg(reinterpret_cast<const uint4*>(row + xs));
  } else {
    unsigned w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      w[m] = (unsigned)__ldg(row + clamp_to(xs + 2 * m, W - 1)) |
             ((unsigned)__ldg(row + clamp_to(xs + 2 * m + 1, W - 1)) << 16);
    p.v = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void load8(const float* row, int xs, int W, bool vec, F32x8& p) {
  if (vec && xs >= 0 && xs + kStrip <= W) {
    p.a = __ldg(reinterpret_cast<const float4*>(row + xs));
    p.b = __ldg(reinterpret_cast<const float4*>(row + xs + 4));
  } else {
    float f[kStrip];
#pragma unroll
    for (int j = 0; j < kStrip; ++j) f[j] = __ldg(row + clamp_to(xs + j, W - 1));
    p.a = make_float4(f[0], f[1], f[2], f[3]);
    p.b = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// uint16 to float32 through __uint2float_rn: exact
__device__ __forceinline__ void unpack8(const U16x8& p, float (&f)[kStrip]) {
  const unsigned w[4] = {p.v.x, p.v.y, p.v.z, p.v.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    f[2 * m] = __uint2float_rn(w[m] & 0xffffu);
    f[2 * m + 1] = __uint2float_rn(w[m] >> 16);
  }
}

__device__ __forceinline__ void unpack8(const F32x8& p, float (&f)[kStrip]) {
  f[0] = p.a.x, f[1] = p.a.y, f[2] = p.a.z, f[3] = p.a.w;
  f[4] = p.b.x, f[5] = p.b.y, f[6] = p.b.z, f[7] = p.b.w;
}

// the tap sum of v[0..N) in tap order, in the contract's form
template <bool kFma, int N>
__device__ __forceinline__ float chain(const float (&v)[N], const float (&k)[N]) {
  float acc;
  if (kFma) {
    acc = __fmaf_rn(v[0], k[0], __fmul_rn(v[1], k[1]));
#pragma unroll
    for (int o = 2; o < N; ++o) acc = __fmaf_rn(v[o], k[o], acc);
  } else {
    acc = __fmul_rn(v[0], k[0]);
#pragma unroll
    for (int o = 1; o < N; ++o) acc = __fadd_rn(acc, __fmul_rn(v[o], k[o]));
  }
  return acc;
}

template <int kHalf, bool kFma, typename T>
__global__ void __launch_bounds__(32 * kRingWarps) blur_ring(
    const T* __restrict__ x, float* __restrict__ out, int H, int W, int tiles_x,
    int tiles_per_plane, long long warps, int vec_in, int vec_out, const Taps taps) {
  constexpr int N = 2 * kHalf + 1;
  constexpr int A = kAhead;
  constexpr int M = N * ((A + N - 1) / N);  // raw slots: the row loop unrolls by M
  using Px = typename Pixels<T>::type;
  const long long item = (long long)blockIdx.x * kRingWarps + (threadIdx.x >> 5);
  if (item >= warps) return;  // the whole warp
  float k[N];
#pragma unroll
  for (int o = 0; o < N; ++o) k[o] = taps.k[o];
  const int lane = threadIdx.x & 31;
  const long long b = item / tiles_per_plane;
  const int tile = (int)(item - b * tiles_per_plane);
  const int y0 = (tile / tiles_x) * kRows;
  const int xs = (tile % tiles_x) * kTileW - kStrip + kStrip * lane;  // the lane's columns
  const int rows = H - y0 < kRows ? H - y0 : kRows;
  const long long plane = (long long)H * W;
  const T* src = x + b * plane;
  auto row = [&](int y) { return src + (long long)clamp_to(y, H - 1) * W; };

  // ring slot s % N holds input row y0 - h + s: rows y0 - h .. y0 + h - 1
  // now, row y0 + i + h enters at step i
  float ring[N][kStrip];
#pragma unroll
  for (int s = 0; s < 2 * kHalf; ++s) {
    Px p;
    load8(row(y0 - kHalf + s), xs, W, vec_in, p);
    unpack8(p, ring[s]);
  }
  // raw[i % M]: step i's new row, loaded A steps before it
  Px raw[M];
#pragma unroll
  for (int i = 0; i < A; ++i)
    if (i < rows) load8(row(y0 + i + kHalf), xs, W, vec_in, raw[i]);

  for (int i0 = 0; i0 < rows; i0 += M) {
#pragma unroll
    for (int u = 0; u < M; ++u) {  // i0 % M == 0, a multiple of N: every index is a constant
      const int i = i0 + u;
      if (i >= rows) continue;  // the same for the whole warp
      unpack8(raw[u], ring[(u + 2 * kHalf) % N]);
      if (i + A < rows) load8(row(y0 + i + A + kHalf), xs, W, vec_in, raw[(u + A) % M]);
      // the column sums of output row y0 + i: input rows y0 + i - h + o,
      // ring slots (u + o) % N, into w[h .. h + 8)
      float w[kStrip + 2 * kHalf];
#pragma unroll
      for (int j = 0; j < kStrip; ++j) {
        float v[N];
#pragma unroll
        for (int o = 0; o < N; ++o) v[o] = ring[(u + o) % N][j];
        w[kHalf + j] = chain<kFma>(v, k);
      }
      // the h column sums left and right of the strip, from the lanes beside
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        w[j] = __shfl_up_sync(kFull, w[kStrip + j], 1);
        w[kStrip + kHalf + j] = __shfl_down_sync(kFull, w[kHalf + j], 1);
      }
      float r[kStrip];
#pragma unroll
      for (int j = 0; j < kStrip; ++j) {
        float v[N];
#pragma unroll
        for (int o = 0; o < N; ++o) v[o] = w[j + o];
        r[j] = chain<kFma>(v, k);
      }
      if (lane != 0 && lane != 31 && xs < W) {
        float* d = out + b * plane + (long long)(y0 + i) * W + xs;
        if (vec_out && xs + kStrip <= W) {
          reinterpret_cast<float4*>(d)[0] = make_float4(r[0], r[1], r[2], r[3]);
          reinterpret_cast<float4*>(d)[1] = make_float4(r[4], r[5], r[6], r[7]);
        } else {
#pragma unroll
          for (int j = 0; j < kStrip; ++j)
            if (xs + j < W) d[j] = r[j];
        }
      }
    }
  }
}

// ---- the shared window (h > kRingMaxHalf) ----

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 32;
constexpr int kWinTileW = 128;

// the tap sum over n = 2h + 1 >= 3 values at p[0], p[stride], ... in tap order
template <bool kFma>
__device__ __forceinline__ float tap_sum(const float* p, int stride, const float* k, int n) {
  float acc;
  if (kFma) {
    acc = __fmaf_rn(p[0], k[0], __fmul_rn(p[stride], k[1]));
    for (int o = 2; o < n; ++o) acc = __fmaf_rn(p[o * stride], k[o], acc);
  } else {
    acc = __fmul_rn(p[0], k[0]);
    for (int o = 1; o < n; ++o) acc = __fadd_rn(acc, __fmul_rn(p[o * stride], k[o]));
  }
  return acc;
}

template <bool kFma, typename T>
__global__ void __launch_bounds__(kThreads) blur_window(
    const T* __restrict__ x, float* __restrict__ out, int H, int W, int tiles_x,
    int tiles_per_plane, int half, const Taps taps) {
  extern __shared__ float smem[];
  __shared__ float k[kMaxTaps];
  const int n = 2 * half + 1;
  for (int o = threadIdx.x; o < n; o += kThreads) k[o] = taps.k[o];
  const int win_h = kTileH + 2 * half, win_w = kWinTileW + 2 * half;
  float* win = smem;                     // [win_h][win_w] input window
  float* col = smem + win_h * win_w;     // [kTileH][win_w] column pass
  const long long plane = (long long)H * W;
  const int b = blockIdx.x / tiles_per_plane;
  const int tile = blockIdx.x - b * tiles_per_plane;
  const int y0 = (tile / tiles_x) * kTileH, x0 = (tile % tiles_x) * kWinTileW;
  const T* src = x + b * plane;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int r = warp; r < win_h; r += kWarps) {
    const T* row = src + (long long)clamp_to(y0 - half + r, H - 1) * W;
    for (int c = lane; c < win_w; c += 32)
      win[r * win_w + c] = to_float(row[clamp_to(x0 - half + c, W - 1)]);
  }
  __syncthreads();
  const int rows = H - y0 < kTileH ? H - y0 : kTileH;
  for (int r = warp; r < rows; r += kWarps)
    for (int c = lane; c < win_w; c += 32)
      col[r * win_w + c] = tap_sum<kFma>(win + r * win_w + c, win_w, k, n);
  __syncthreads();
  const int cols = W - x0 < kWinTileW ? W - x0 : kWinTileW;
  float* dst = out + b * plane + (long long)y0 * W + x0;
  for (int r = warp; r < rows; r += kWarps)
    for (int c = lane; c < cols; c += 32)
      dst[(long long)r * W + c] = tap_sum<kFma>(col + r * win_w + c, 1, k, n);
}

// a 1-D grid of blocks; no plane that fits on the card comes near the limit
constexpr long long kMaxBlocks = 1ll << 31;

template <bool kFma, typename T>
cudaError_t launch_window(const void* x, void* out, int B, int H, int W, const Taps& taps,
                          int half, cudaStream_t s) {
  const int tiles_x = (W + kWinTileW - 1) / kWinTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const long long tiles_per_plane = (long long)tiles_x * tiles_y;
  const long long blocks = tiles_per_plane * B;
  if (blocks >= kMaxBlocks) return cudaErrorInvalidValue;
  const int win_w = kWinTileW + 2 * half;
  const size_t smem = sizeof(float) * (size_t)(kTileH + 2 * half + kTileH) * win_w;
  cudaError_t e = cudaFuncSetAttribute(blur_window<kFma, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  blur_window<kFma, T><<<(unsigned)blocks, kThreads, smem, s>>>(
      (const T*)x, (float*)out, H, W, tiles_x, (int)tiles_per_plane, half, taps);
  return cudaGetLastError();
}

template <int kHalf, bool kFma, typename T>
cudaError_t launch_ring(const void* x, void* out, int B, int H, int W, const Taps& taps,
                        cudaStream_t s) {
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kRows - 1) / kRows;
  const long long tiles_per_plane = (long long)tiles_x * tiles_y;
  const long long warps = tiles_per_plane * B;
  const long long blocks = (warps + kRingWarps - 1) / kRingWarps;
  if (blocks >= kMaxBlocks) return cudaErrorInvalidValue;
  // 16-byte loads need a 16-byte aligned base and rows of whole vectors
  const int vec_in = ((uintptr_t)x % 16 == 0) && (W % (16 / (int)sizeof(T)) == 0);
  const int vec_out = ((uintptr_t)out % 16 == 0) && (W % 4 == 0);
  blur_ring<kHalf, kFma, T><<<(unsigned)blocks, 32 * kRingWarps, 0, s>>>(
      (const T*)x, (float*)out, H, W, tiles_x, (int)tiles_per_plane, warps, vec_in, vec_out,
      taps);
  return cudaGetLastError();
}

template <bool kFma, typename T>
cudaError_t launch(const void* x, void* out, int B, int H, int W, const Taps& taps, int half,
                   cudaStream_t s) {
  switch (half) {
    case 1: return launch_ring<1, kFma, T>(x, out, B, H, W, taps, s);
    case 2: return launch_ring<2, kFma, T>(x, out, B, H, W, taps, s);
    case 3: return launch_ring<3, kFma, T>(x, out, B, H, W, taps, s);
    case 4: return launch_ring<4, kFma, T>(x, out, B, H, W, taps, s);
    case 5: return launch_ring<5, kFma, T>(x, out, B, H, W, taps, s);
    default: return launch_window<kFma, T>(x, out, B, H, W, taps, half, s);
  }
}
static_assert(kRingMaxHalf == 5, "launch() names one ring kernel per half-width 1..5");

}  // namespace

// x: uint16 (is_u16) or float32 [B, H, W]; out: float32 [B, H, W]; taps:
// host float32 [n], n = 2h + 1, 1 <= h <= kMaxHalf; fma selects the form.
extern "C" int pcis_gaussian_blur(const void* x, int is_u16, void* out, int B, int H, int W,
                                  const float* taps, int n, int fma, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (long long)H * W >= (1ll << 31) || n < 3 ||
      n % 2 == 0 || n > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int o = 0; o < n; ++o) t.k[o] = taps[o];
  const int half = n / 2;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (is_u16)
    e = fma ? launch<true, unsigned short>(x, out, B, H, W, t, half, s)
            : launch<false, unsigned short>(x, out, B, H, W, t, half, s);
  else
    e = fma ? launch<true, float>(x, out, B, H, W, t, half, s)
            : launch<false, float>(x, out, B, H, W, t, half, s);
  return (int)e;
}
