// K1: exact scipy.ndimage.median_filter(size, mode='reflect') of uint8 label
// planes with values in [0, num_classes) (larger values clamp to
// num_classes-1, as in the plain version).
//
// Replaces: particle_col_image_segmentation_tpu/ops/filters_tiles.py
//   _median_kernel (launched by median_label_filter_pallas).
//
// Bound on this card: memory. Each pixel is read once and written once
// (2 bytes/px); the window work is ~size^2 integer adds per output pixel,
// far below the ALU rate at that traffic.  The TPU kernel pre-reflected rows
// in HBM and corrected wrapped columns with rolls; here a block stages a
// 32x32 output tile plus a `half`-pixel halo in shared memory, reflecting
// indices as it loads, so the plane is read once with no padded copy.
//
// Median by counts: median = #{v < K-1 : count(window <= v) < half_rank}.
// The K-1 <= 7 threshold counts ride packed fields of one 64-bit register
// (field width = bit length of size^2, so no field carries into the next),
// and a 256-entry shared table maps a pixel value to its packed indicator
// word, so one window pixel costs one shared load and one 64-bit add.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // output tile edge
constexpr int kRowsPerPass = 8;  // blockDim.y; each thread covers 4 rows

// scipy 'reflect' (numpy 'symmetric'): -1 -> 0, -2 -> 1, n -> n-1; periodic
// with period 2n, so any halo works even on planes narrower than it.
__device__ __forceinline__ int reflect(int i, int n) {
  int p = 2 * n;
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - 1 - i;
}

template <int HALF>
__global__ void median_kernel(const uint8_t* __restrict__ in,
                              uint8_t* __restrict__ out, int H, int W,
                              int num_classes, int bits) {
  constexpr int SIZE = 2 * HALF + 1;
  constexpr int SW = kTile + 2 * HALF;
  __shared__ uint8_t tile[SW][SW];
  __shared__ unsigned long long le_word[256];

  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kRowsPerPass;
  const int nthr = num_classes - 1;  // thresholds v = 0 .. K-2
  for (int x = tid; x < 256; x += nthreads) {
    unsigned long long w = 0;
    for (int v = x; v < nthr; ++v) w |= 1ull << (bits * v);
    le_word[x] = w;  // field v holds (x <= v)
  }

  const long long plane = (long long)H * W;
  const uint8_t* src = in + blockIdx.z * plane;
  uint8_t* dst = out + blockIdx.z * plane;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  for (int i = tid; i < SW * SW; i += nthreads) {
    int rr = reflect(r0 - HALF + i / SW, H);
    int cc = reflect(c0 - HALF + i % SW, W);
    tile[i / SW][i % SW] = src[(long long)rr * W + cc];
  }
  __syncthreads();

  const int half_rank = SIZE * SIZE / 2 + 1;
  const unsigned long long fmask = (1ull << bits) - 1;
  const int tx = threadIdx.x;
  for (int ty = threadIdx.y; ty < kTile; ty += kRowsPerPass) {
    const int r = r0 + ty, c = c0 + tx;
    if (r >= H || c >= W) continue;
    unsigned long long acc = 0;
#pragma unroll
    for (int dy = 0; dy < SIZE; ++dy)
#pragma unroll
      for (int dx = 0; dx < SIZE; ++dx) acc += le_word[tile[ty + dy][tx + dx]];
    int med = 0;
    for (int v = 0; v < nthr; ++v)
      med += (int)(((acc >> (bits * v)) & fmask) < (unsigned long long)half_rank);
    dst[(long long)r * W + c] = (uint8_t)med;
  }
}

}  // namespace

extern "C" int pcis_median_u8(const void* in, void* out, int B, int H, int W,
                              int size, int num_classes, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || (H + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  if (size % 2 == 0 || size < 3 || size > 9 || num_classes < 1 ||
      num_classes > 8)
    return (int)cudaErrorInvalidValue;
  const int bits = 32 - __builtin_clz(size * size);  // bit length of size^2
  dim3 block(kTile, kRowsPerPass);
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* i8 = (const uint8_t*)in;
  uint8_t* o8 = (uint8_t*)out;
  switch (size / 2) {
    case 1: median_kernel<1><<<grid, block, 0, s>>>(i8, o8, H, W, num_classes, bits); break;
    case 2: median_kernel<2><<<grid, block, 0, s>>>(i8, o8, H, W, num_classes, bits); break;
    case 3: median_kernel<3><<<grid, block, 0, s>>>(i8, o8, H, W, num_classes, bits); break;
    default: median_kernel<4><<<grid, block, 0, s>>>(i8, o8, H, W, num_classes, bits); break;
  }
  return (int)cudaGetLastError();
}
