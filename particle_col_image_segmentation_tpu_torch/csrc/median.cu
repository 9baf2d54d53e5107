// K1: exact scipy.ndimage.median_filter(size, mode='reflect') of uint8 label
// planes with values in [0, num_classes) (larger values clamp to
// num_classes-1, as in the plain version).
//
// Replaces: particle_col_image_segmentation_tpu/ops/filters_tiles.py
//   _median_kernel (launched by median_label_filter_pallas).
//
// Median by counts: median = #{v < K-1 : count(window <= v) < half_rank}.
// The K-1 <= 7 threshold counts ride packed fields of one 64-bit word, each
// one bit wider than size^2 needs (at most 7 x 8 bits).  The indicator word
// of a value x is `ones` (a 1 in every field) with the fields below x
// cleared.  The spare top bit of each field reads all K-1 comparisons at
// once: adding 2^bits - half_rank to every field sets it exactly where
// count >= half_rank, and no field carries into the next, so the median is
// K-1 minus a popcount.
//
// Bound on this card: memory, 2 bytes a pixel; what holds the kernel back
// is shared-memory traffic and the block's barriers.  A direct window sum
// costs 2*size^2 shared loads a pixel (a byte and a table word per window
// pixel).  So a block stages a 32-wide, 64-row output tile plus its
// `half`-pixel halo once, each staged pixel mapped to its indicator word;
// sums each column's `size` words by a window sliding down 8 rows (two
// loads a step); and adds `size` column sums across: about size + 3 shared
// loads an output pixel.  Interior tiles are staged with 16-byte loads,
// copied to shared memory as they are and mapped to words by consecutive
// threads (no bank conflicts); only tiles that touch the plane's edge
// reflect their indices (scipy 'reflect', periodic, so any halo works on
// planes narrower than it).  The plane is read once, with no padded copy.
//
// Band mode (row_padded = 1), for a plane split into row bands over a mesh:
// the input holds H + 2*half rows, the band's own H rows between `half`
// halo rows above and below that the caller took from the neighbouring
// bands (or reflected at the plane's true edges).  Those rows are read as
// given; only the columns are reflected.  The output has H rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;   // output tile width: one column a lane
constexpr int kTileH = 64;   // output tile height
constexpr int kRows = 8;     // blockDim.y
constexpr int kThreads = kTileW * kRows;
constexpr int kRun = 8;      // rows of one sliding column sum
constexpr int kChunk = 16;   // bytes of a vector load

// scipy 'reflect' (numpy 'symmetric'): -1 -> 0, -2 -> 1, n -> n-1; periodic
// with period 2n, so any halo works even on planes narrower than it.
__device__ __forceinline__ int reflect(int i, int n) {
  int p = 2 * n;
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - 1 - i;
}

// The packed indicator word of a pixel value x: field v holds (x <= v).
__device__ __forceinline__ unsigned long long indicator(int x, int nthr, int fw,
                                                         unsigned long long ones) {
  return x < nthr ? ones & (~0ull << (fw * x)) : 0ull;
}

template <int HALF>
__global__ void __launch_bounds__(kThreads)
median_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int H, int W,
              int H_in, int row_shift, int num_classes, int fw, unsigned long long ones,
              unsigned long long add, unsigned long long guard, int aligned) {
  constexpr int SIZE = 2 * HALF + 1;
  constexpr int SW = kTileW + 2 * HALF;  // staged columns
  constexpr int SH = kTileH + 2 * HALF;  // staged rows
  __shared__ unsigned long long word[SH * SW];  // indicator word a staged pixel
  // SIZE words down a column; before that, an interior tile's staged bytes
  __shared__ __align__(16) unsigned long long colsum[kTileH * SW];
  static_assert(SH * 4 * kChunk <= kTileH * SW * 8, "staged bytes fit in colsum");

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int nthr = num_classes - 1;  // thresholds v = 0 .. K-2

  const long long plane = (long long)H * W;
  const uint8_t* src = in + blockIdx.z * (long long)H_in * W;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  // the input row of staged row 0: output row r reads input rows
  // r + row_shift - HALF .. r + row_shift + HALF
  const int s0 = r0 - HALF + row_shift;
  if (aligned && s0 >= 0 && s0 + SH <= H_in && c0 >= kChunk &&
      c0 + kTileW + kChunk <= W) {
    // interior: a staged row lies in the four 16-byte chunks c0-16 .. c0+47,
    // copied as they are (consecutive threads, consecutive chunks), then
    // mapped to words (consecutive threads, consecutive words)
    uint4* bytes = reinterpret_cast<uint4*>(colsum);
    for (int j = tid; j < SH * 4; j += kThreads)
      bytes[j] = *reinterpret_cast<const uint4*>(
          src + (long long)(s0 + (j >> 2)) * W + c0 - kChunk + kChunk * (j & 3));
    __syncthreads();
    const uint8_t* b8 = reinterpret_cast<const uint8_t*>(colsum);
    for (int i = tid; i < SH * SW; i += kThreads)
      word[i] = indicator(b8[(i / SW) * 4 * kChunk + kChunk - HALF + i % SW], nthr, fw, ones);
  } else {
    for (int i = tid; i < SH * SW; i += kThreads) {
      // band mode: every row an output row reads lies in the input; the
      // reflection only keeps the staged rows past the last output row
      // (never read) in bounds
      const int rr = reflect(s0 + i / SW, H_in);
      const int cc = reflect(c0 - HALF + i % SW, W);
      word[i] = indicator(src[(long long)rr * W + cc], nthr, fw, ones);
    }
  }
  __syncthreads();

  // column sums: a window of SIZE words sliding down kRun rows (fields never
  // borrow: each holds a count at least as large as what leaves it)
  for (int j = tid; j < SW * (kTileH / kRun); j += kThreads) {
    const int x = j % SW, y0 = (j / SW) * kRun;
    unsigned long long acc = 0;
#pragma unroll
    for (int dy = 0; dy < SIZE; ++dy) acc += word[(y0 + dy) * SW + x];
    colsum[y0 * SW + x] = acc;
#pragma unroll
    for (int k = 1; k < kRun; ++k) {
      acc += word[(y0 + k + SIZE - 1) * SW + x] - word[(y0 + k - 1) * SW + x];
      colsum[(y0 + k) * SW + x] = acc;
    }
  }
  __syncthreads();

  uint8_t* dst = out + blockIdx.z * plane;
  const int tx = threadIdx.x;
  for (int ty = threadIdx.y; ty < kTileH; ty += kRows) {
    const int r = r0 + ty, c = c0 + tx;
    if (r >= H || c >= W) continue;
    unsigned long long acc = 0;
#pragma unroll
    for (int dx = 0; dx < SIZE; ++dx) acc += colsum[ty * SW + tx + dx];
    dst[(long long)r * W + c] = (uint8_t)(nthr - __popcll((acc + add) & guard));
  }
}

}  // namespace

// row_padded: 0 for a whole plane [B, H, W] (rows and columns reflected),
// 1 for a band [B, H + 2*(size/2), W] whose halo rows are given.
extern "C" int pcis_median_u8(const void* in, void* out, int B, int H, int W,
                              int size, int num_classes, int row_padded, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || (H + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  if (size % 2 == 0 || size < 3 || size > 9 || num_classes < 1 ||
      num_classes > 8 || (row_padded != 0 && row_padded != 1))
    return (int)cudaErrorInvalidValue;
  const int row_shift = row_padded ? size / 2 : 0;
  const int H_in = H + 2 * row_shift;
  // fields of bits + 1: bits = bit length of size^2 holds any window count,
  // the top bit is the guard that `add` sets where count >= half_rank
  const int bits = 32 - __builtin_clz(size * size);
  const int fw = bits + 1, half_rank = size * size / 2 + 1;
  unsigned long long ones = 0, add = 0, guard = 0;
  for (int v = 0; v < num_classes - 1; ++v) {
    ones |= 1ull << (fw * v);
    add |= (unsigned long long)((1 << bits) - half_rank) << (fw * v);
    guard |= 1ull << (fw * v + bits);
  }
  // 16-byte loads need every row start on a 16-byte boundary
  const int aligned = W % kChunk == 0 && (uintptr_t)in % kChunk == 0;
  dim3 block(kTileW, kRows);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* i8 = (const uint8_t*)in;
  uint8_t* o8 = (uint8_t*)out;
  switch (size / 2) {
    case 1: median_kernel<1><<<grid, block, 0, s>>>(i8, o8, H, W, H_in, row_shift, num_classes, fw, ones, add, guard, aligned); break;
    case 2: median_kernel<2><<<grid, block, 0, s>>>(i8, o8, H, W, H_in, row_shift, num_classes, fw, ones, add, guard, aligned); break;
    case 3: median_kernel<3><<<grid, block, 0, s>>>(i8, o8, H, W, H_in, row_shift, num_classes, fw, ones, add, guard, aligned); break;
    default: median_kernel<4><<<grid, block, 0, s>>>(i8, o8, H, W, H_in, row_shift, num_classes, fw, ones, add, guard, aligned); break;
  }
  return (int)cudaGetLastError();
}
