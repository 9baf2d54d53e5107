// Plateau maxima after K2: mark the plateaus that have a higher neighbour,
// then resolve each pixel from its plateau's mark.
//
// Replaces no TPU kernel: the JAX package's local_maxima_auto rides K2's
// band sweeps (particle_col_image_segmentation_tpu/ops/morphology.py).  On
// the card the same step was PyTorch glue (ops/morphology.py _has_higher,
// nine compares and eight in-place ORs on strided views, then
// _marked_components: an int64 key of the whole stack, a boolean index and
// an index store, each a host sync, and a gather).
//
// Contract (same as ops.morphology.local_maxima on K2's components): with
// root[b, p] the minimum per-plane linear index of p's equal-value component
// (K2's labels, 4- or 8-connected as `connectivity`),
//   out[b, p] = no pixel q with root[b, q] == root[b, p] has an in-plane
//               neighbour (4 or 8) whose value is strictly greater;
// plane edges have no neighbour there.  Every comparison is the exact
// integer one of the plain version, so the answer is bit for bit its own.
//
// Bound on this card: HBM.  The least traffic reads a pixel's value and root
// (8 B for int32 values), writes its bool (1 B) and reads its root again in
// the second pass (4 B): ~13 B a pixel.  The flags take one bit a pixel of
// the stack (4.2 MB at [8, 2048²]) and stay in L2.  The design:
//   0. one cudaMemsetAsync clears the bitset;
//   1. maxima_mark: a warp holds 128 columns (four consecutive pixels a
//      lane, 16-byte loads where the rows allow) and walks down 16 rows
//      with the rows above and below in registers; the columns left and
//      right of a lane's four come from its neighbour lanes by shuffles
//      (a load at the warp's two ends).  A pixel with a strictly higher
//      neighbour names bit b·H·W + root; a lane merges its pixels' bits that
//      share a word, lanes naming one word meet in a __match_any_sync group,
//      and its lowest lane ORs the group's bits in with one atomicOr.  A
//      plateau's pixels share one root, so a warp names few words a row;
//   2. maxima_resolve: out = !bit(b·H·W + root), four pixels a thread with
//      16-byte root loads and 4-byte stores where the planes allow.
// No value is read back by the host.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPx = 4;                  // consecutive pixels a lane
constexpr int kSpan = 32 * kPx;         // columns a warp
constexpr int kWarps = 8;               // warps a block, one above the other
constexpr int kRows = 16;               // rows a warp walks down
constexpr int kThreads = 256;           // maxima_resolve's block
constexpr int kResolveIters = 8;        // maxima_resolve: groups of four a thread

// A value no neighbour is strictly greater than: what lies off the plane.
template <typename V> struct Lowest;
template <> struct Lowest<uint8_t> { static constexpr uint8_t value = 0; };
template <> struct Lowest<int32_t> { static constexpr int32_t value = INT32_MIN; };

template <typename V> struct Quad;
template <> struct Quad<uint8_t> { using T = uchar4; };
template <> struct Quad<int32_t> { using T = int4; };

// A lane's window of one row: columns c0 - 1 .. c0 + 4.
template <typename V>
struct Row {
  V m[kPx + 2];
};

// Row r's window for the lane at column c0; every lane of the warp calls it
// with the same r.  Off the plane, Lowest.
template <typename V, bool kVec>
__device__ __forceinline__ Row<V> load_row(const V* __restrict__ v, int r, int c0, int H,
                                           int W, int lane) {
  Row<V> w;
  const V low = Lowest<V>::value;
#pragma unroll
  for (int k = 0; k < kPx + 2; ++k) w.m[k] = low;
  if (r < 0 || r >= H) return w;  // warp-uniform
  const V* row = v + (long long)r * W;
  if (kVec && c0 < W) {  // W % 4 == 0, so the lane's four are on the plane
    const typename Quad<V>::T q = *reinterpret_cast<const typename Quad<V>::T*>(row + c0);
    w.m[1] = q.x;
    w.m[2] = q.y;
    w.m[3] = q.z;
    w.m[4] = q.w;
  } else if (!kVec) {
#pragma unroll
    for (int k = 0; k < kPx; ++k)
      if (c0 + k < W) w.m[k + 1] = row[c0 + k];
  }
  const int left = __shfl_up_sync(kFull, (int)w.m[kPx], 1);
  const int right = __shfl_down_sync(kFull, (int)w.m[1], 1);
  if (lane > 0) {
    w.m[0] = (V)left;
  } else if (c0 > 0 && c0 - 1 < W) {
    w.m[0] = row[c0 - 1];
  }
  if (lane < 31) {
    w.m[kPx + 1] = (V)right;
  } else if (c0 + kPx < W) {
    w.m[kPx + 1] = row[c0 + kPx];
  }
  return w;
}

template <typename V, bool kVec, bool kDiag>
__global__ void __launch_bounds__(32 * kWarps)
maxima_mark(const V* __restrict__ val, const int* __restrict__ root,
            unsigned* __restrict__ bits, int H, int W) {
  const int lane = threadIdx.x;
  const int r0 = (blockIdx.y * kWarps + threadIdx.y) * kRows;
  if (r0 >= H) return;  // the whole warp
  const int r1 = r0 + kRows < H ? r0 + kRows : H;
  const long long plane = (long long)H * W;
  const unsigned long long base = (unsigned long long)blockIdx.z * plane;  // bit offset
  const V* v = val + blockIdx.z * plane;
  const int* rt = root + blockIdx.z * plane;
  const int c0 = blockIdx.x * kSpan + lane * kPx;
  Row<V> up = load_row<V, kVec>(v, r0 - 1, c0, H, W, lane);
  Row<V> cur = load_row<V, kVec>(v, r0, c0, H, W, lane);
  for (int r = r0; r < r1; ++r) {
    const Row<V> dn = load_row<V, kVec>(v, r + 1, c0, H, W, lane);
    unsigned hi = 0;  // bit k: pixel c0 + k has a strictly higher neighbour
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      const V x = cur.m[k + 1];
      bool h = cur.m[k] > x || cur.m[k + 2] > x || up.m[k + 1] > x || dn.m[k + 1] > x;
      if (kDiag) h = h || up.m[k] > x || up.m[k + 2] > x || dn.m[k] > x || dn.m[k + 2] > x;
      if (h && c0 + k < W) hi |= 1u << k;
    }
    // the word and bits each pixel names (~0: none), those sharing a word
    // merged into the first of them
    unsigned long long word[kPx];
    unsigned mask[kPx];
    if (hi) {
      const int* rr = rt + (long long)r * W + c0;
      int q[kPx];
      if (kVec) {
        const int4 t = *reinterpret_cast<const int4*>(rr);
        q[0] = t.x;
        q[1] = t.y;
        q[2] = t.z;
        q[3] = t.w;
      } else {
#pragma unroll
        for (int k = 0; k < kPx; ++k) q[k] = (hi >> k) & 1u ? rr[k] : 0;
      }
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        const unsigned long long key = base + (unsigned)q[k];
        word[k] = (hi >> k) & 1u ? key >> 5 : ~0ull;
        mask[k] = 1u << (key & 31);
      }
#pragma unroll
      for (int k = 1; k < kPx; ++k) {
#pragma unroll
        for (int j = 0; j < k; ++j) {
          if (word[k] != ~0ull && word[k] == word[j]) {
            mask[j] |= mask[k];
            word[k] = ~0ull;
          }
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        word[k] = ~0ull;
        mask[k] = 0;
      }
    }
    // lanes naming one word OR their bits together; its lowest lane stores
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      const bool named = word[k] != ~0ull;
      if (!__any_sync(kFull, named)) continue;
      const unsigned peers = __match_any_sync(kFull, word[k]);
      if (named) {
        const unsigned all = __reduce_or_sync(peers, mask[k]);
        if (lane == __ffs(peers) - 1) atomicOr(&bits[word[k]], all);
      }
    }
    up = cur;
    cur = dn;
  }
}

__device__ __forceinline__ uint8_t unmarked(const unsigned* __restrict__ bits,
                                            unsigned long long key) {
  return (uint8_t)(((bits[key >> 5] >> (key & 31)) & 1u) ^ 1u);
}

// out = !bit(b·H·W + root), four pixels a thread (planes of a multiple of 4
// pixels, 16-byte aligned roots and 4-byte aligned bools) or one.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
maxima_resolve(const int* __restrict__ root, const unsigned* __restrict__ bits,
               uint8_t* __restrict__ out, long long plane) {
  const unsigned long long base = (unsigned long long)blockIdx.y * plane;
  const int* rt = root + blockIdx.y * plane;
  uint8_t* o = out + blockIdx.y * plane;
  const long long n = kVec ? plane / kPx : plane;
  const long long start = (long long)blockIdx.x * kThreads * kResolveIters;
#pragma unroll
  for (int i = 0; i < kResolveIters; ++i) {
    const long long g = start + (long long)i * kThreads + threadIdx.x;
    if (g >= n) return;
    if (kVec) {
      const int4 t = reinterpret_cast<const int4*>(rt)[g];
      uchar4 u;
      u.x = unmarked(bits, base + (unsigned)t.x);
      u.y = unmarked(bits, base + (unsigned)t.y);
      u.z = unmarked(bits, base + (unsigned)t.z);
      u.w = unmarked(bits, base + (unsigned)t.w);
      reinterpret_cast<uchar4*>(o)[g] = u;
    } else {
      o[g] = unmarked(bits, base + (unsigned)rt[g]);
    }
  }
}

long long words_len(int B, int H, int W) {
  return ((long long)B * H * W + 31) / 32;
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename V>
int launch(const V* val, const int* root, unsigned* bits, long long words, uint8_t* out,
           int B, int H, int W, int connectivity, cudaStream_t s) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || (connectivity != 4 && connectivity != 8))
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)H * W;
  const long long rows = (H + kWarps * kRows - 1) / (kWarps * kRows);
  if (plane >= (1ll << 31) || rows > 65535 || words < words_len(B, H, W))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(bits, 0, sizeof(unsigned) * (size_t)words_len(B, H, W), s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((W + kSpan - 1) / kSpan), (unsigned)rows, B);
  const dim3 block(32, kWarps);
  // rows start on 16-byte boundaries for 16-byte value and root loads
  const bool vec = W % kPx == 0 && aligned(val, sizeof(V) * kPx) && aligned(root, 16);
  if (connectivity == 8) {
    if (vec) maxima_mark<V, true, true><<<grid, block, 0, s>>>(val, root, bits, H, W);
    else maxima_mark<V, false, true><<<grid, block, 0, s>>>(val, root, bits, H, W);
  } else {
    if (vec) maxima_mark<V, true, false><<<grid, block, 0, s>>>(val, root, bits, H, W);
    else maxima_mark<V, false, false><<<grid, block, 0, s>>>(val, root, bits, H, W);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool vec_out = plane % kPx == 0 && aligned(root, 16) && aligned(out, kPx);
  const long long n = vec_out ? plane / kPx : plane;
  const dim3 rgrid((unsigned)((n + kThreads * kResolveIters - 1) / (kThreads * kResolveIters)),
                   B);
  if (vec_out) {
    maxima_resolve<true><<<rgrid, kThreads, 0, s>>>(root, bits, out, plane);
  } else {
    maxima_resolve<false><<<rgrid, kThreads, 0, s>>>(root, bits, out, plane);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// uint32 words of the bitset that pcis_plateau_maxima_* needs as scratch
extern "C" long long pcis_maxima_scratch_len(int B, int H, int W) {
  return words_len(B, H, W);
}

extern "C" int pcis_plateau_maxima_u8(const void* val, const void* root, void* bits,
                                      long long words, void* out, int B, int H, int W,
                                      int connectivity, void* stream) {
  return launch<uint8_t>((const uint8_t*)val, (const int*)root, (unsigned*)bits, words,
                         (uint8_t*)out, B, H, W, connectivity, (cudaStream_t)stream);
}

extern "C" int pcis_plateau_maxima_i32(const void* val, const void* root, void* bits,
                                       long long words, void* out, int B, int H, int W,
                                       int connectivity, void* stream) {
  return launch<int32_t>((const int32_t*)val, (const int*)root, (unsigned*)bits, words,
                         (uint8_t*)out, B, H, W, connectivity, (cudaStream_t)stream);
}
