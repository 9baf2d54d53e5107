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
// 4 B a float32 pixel written.  Design:
//   - one block a TH x TW tile of a plane: the (TH + 2h) x (TW + 2h) input
//     window into shared memory with clamped indices (replicate padding),
//     uint16 converted to float in the load (exact);
//   - the column pass over the window's TW + 2h columns into a second
//     shared buffer, then the row pass from it, written as float32;
//   - warps walk rows, lanes columns: global loads and stores coalesced,
//     shared accesses free of bank conflicts, each tap one broadcast read
//     from a shared copy of the taps;
//   - a 1-D grid over (plane, tile row, tile column), so any B fits.
// The taps ride in the launch's parameters: no device copy, no host sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kMaxHalf = 64;  // ops.blur_tiles.MAX_HALF
constexpr int kMaxTaps = 2 * kMaxHalf + 1;

struct Taps {
  float k[kMaxTaps];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(unsigned short v) { return __uint2float_rn(v); }

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
__global__ void __launch_bounds__(kThreads) blur_kernel(
    const T* __restrict__ x, float* __restrict__ out, int H, int W, int tiles_x,
    int tiles_per_plane, int half, const Taps taps) {
  extern __shared__ float smem[];
  __shared__ float k[kMaxTaps];
  const int n = 2 * half + 1;
  for (int o = threadIdx.x; o < n; o += kThreads) k[o] = taps.k[o];
  const int win_h = kTileH + 2 * half, win_w = kTileW + 2 * half;
  float* win = smem;                     // [win_h][win_w] input window
  float* col = smem + win_h * win_w;     // [kTileH][win_w] column pass
  const long long plane = (long long)H * W;
  const int b = blockIdx.x / tiles_per_plane;
  const int tile = blockIdx.x - b * tiles_per_plane;
  const int y0 = (tile / tiles_x) * kTileH, x0 = (tile % tiles_x) * kTileW;
  const T* src = x + b * plane;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int r = warp; r < win_h; r += kWarps) {
    int y = y0 - half + r;
    y = y < 0 ? 0 : (y > H - 1 ? H - 1 : y);
    const T* row = src + (long long)y * W;
    for (int c = lane; c < win_w; c += 32) {
      int xx = x0 - half + c;
      xx = xx < 0 ? 0 : (xx > W - 1 ? W - 1 : xx);
      win[r * win_w + c] = to_float(row[xx]);
    }
  }
  __syncthreads();
  const int rows = H - y0 < kTileH ? H - y0 : kTileH;
  for (int r = warp; r < rows; r += kWarps)
    for (int c = lane; c < win_w; c += 32)
      col[r * win_w + c] = tap_sum<kFma>(win + r * win_w + c, win_w, k, n);
  __syncthreads();
  const int cols = W - x0 < kTileW ? W - x0 : kTileW;
  float* dst = out + b * plane + (long long)y0 * W + x0;
  for (int r = warp; r < rows; r += kWarps)
    for (int c = lane; c < cols; c += 32)
      dst[(long long)r * W + c] = tap_sum<kFma>(col + r * win_w + c, 1, k, n);
}

template <bool kFma, typename T>
cudaError_t launch(const void* x, void* out, int B, int H, int W, const Taps& taps, int half,
                   cudaStream_t s) {
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const long long tiles_per_plane = (long long)tiles_x * tiles_y;
  const long long blocks = tiles_per_plane * B;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  const int win_w = kTileW + 2 * half;
  const size_t smem = sizeof(float) * (size_t)(kTileH + 2 * half + kTileH) * win_w;
  cudaError_t e = cudaFuncSetAttribute(blur_kernel<kFma, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  blur_kernel<kFma, T><<<(unsigned)blocks, kThreads, smem, s>>>(
      (const T*)x, (float*)out, H, W, tiles_x, (int)tiles_per_plane, half, taps);
  return cudaGetLastError();
}

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
