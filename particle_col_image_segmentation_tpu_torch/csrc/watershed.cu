// K10 and K11: the two phases of the marker watershed, one pass each.
//
// Replaces: particle_col_image_segmentation_tpu/ops/watershed_tiles.py
//   _cost_kernel (K10, body _relax_cost) and _label_kernel (K11, body
//   _relax_label), launched by _make_sweep and driven by watershed_sweeps
//   (dispatched by watershed_auto).
//
// Contract (same as ops.watershed.watershed, whose two fixpoints are unique,
// so any schedule gives the same labels bit for bit):
//   K10, phase 1: cost[p] = min over neighbours n of max(cost[n], img[p]),
//     seeds fixed at img, pixels outside the mask at +INF;
//   K11, phase 2: with cost fixed, each masked non-seed pixel takes the
//     lexicographically least claim (level distance, entry img, claimer img,
//     marker id) over its optimal edges, recomputed from scratch from the
//     neighbours' states; seeds hold (marker, 0, -INF) and pixels outside
//     the mask (BIG, BIG, +INF), as the caller initialised them.
// flags: bit 0 = in mask, bit 1 = seed (seeds lie in the mask).
//
// Bound on this card: the passes.  Each pass reads and writes every plane's
// state once (about 9 B a pixel for K10 and 21 B for K11), and the number of
// passes follows the basins' extent in tiles.  The TPU relaxed full-width row
// bands in VMEM with Gauss-Seidel band sweeps; here one block takes a 32x32
// output tile of one plane (blockIdx.z) with a one-pixel halo and relaxes it
// in shared memory until the tile stops changing, so each pass moves a front
// across whole tiles instead of one pixel.  Pixels past a plane's edge read
// as sentinels, so planes never leak into each other.
//   K10 is monotone (costs only fall), so the tile relaxes in place.
//   K11 is not (the level reset), so each inner step is a Jacobi step
//   between two shared buffers, and only interior pixels are recomputed: the
//   halo stays frozen at its loaded, valid values.
// A block may read a neighbour tile's state while that tile's block writes
// it.  This is safe because the host stops after a pass in which no block
// of any plane changed a pixel: every block then read the final state and
// found it a fixpoint, and the fixpoint is unique.  Each block that changes
// a pixel sets changed[plane] = 1 (an idempotent store).  Comparisons are
// float equalities of values copied from img or the sentinels, with no float
// arithmetic, so no fast-math flag may be used.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kSide = kTile + 2;  // tile plus a one-pixel halo
constexpr int kMaxInner = 4 * kTile * kTile;  // guard on one tile's inner steps
constexpr float kInf = 3.4e38f;
constexpr int kBigLab = INT_MAX;
constexpr uint8_t kMaskBit = 1;
constexpr uint8_t kSeedBit = 2;

// the 4 (connectivity 1) or 8 (connectivity 2) neighbour offsets
__constant__ int kDy[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
__constant__ int kDx[8] = {0, 0, -1, 1, -1, 1, -1, 1};

__global__ void __launch_bounds__(kTile * kTile)
cost_pass(const float* __restrict__ img, const uint8_t* __restrict__ flags,
          float* cost, int* changed, int H, int W, int nnb) {
  __shared__ float s_cost[kSide][kSide];
  __shared__ float s_img[kSide][kSide];
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const long long off = (long long)blockIdx.z * H * W;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < kSide * kSide; i += kTile * kTile) {
    const int ly = i / kSide, lx = i % kSide;
    const int gy = y0 + ly - 1, gx = x0 + lx - 1;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const long long g = off + (long long)gy * W + gx;
    s_cost[ly][lx] = in ? cost[g] : kInf;
    s_img[ly][lx] = in ? img[g] : kInf;
  }
  const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  const long long g = off + (long long)gy * W + gx;
  bool upd = false;
  if (gy < H && gx < W) {
    const uint8_t f = flags[g];
    upd = (f & kMaskBit) && !(f & kSeedBit);
  }
  __syncthreads();
  const float im = s_img[ly][lx];
  const float c0 = s_cost[ly][lx];
  bool again = true;
  for (int step = 0; again && step < kMaxInner; ++step) {
    bool ch = false;
    if (upd) {
      float best = s_cost[ly][lx];
      for (int k = 0; k < nnb; ++k) {
        const float nc = s_cost[ly + kDy[k]][lx + kDx[k]];
        const float v = nc > im ? nc : im;
        best = v < best ? v : best;
      }
      if (best < s_cost[ly][lx]) {
        s_cost[ly][lx] = best;  // monotone: a racing reader sees either value
        ch = true;
      }
    }
    again = __syncthreads_or(ch);
  }
  const bool mine = upd && s_cost[ly][lx] != c0;
  if (mine) cost[g] = s_cost[ly][lx];
  if (__syncthreads_or(mine) && tid == 0) changed[blockIdx.z] = 1;
}

__global__ void __launch_bounds__(kTile * kTile)
label_pass(const float* __restrict__ cost, const float* __restrict__ img,
           const uint8_t* __restrict__ flags, int* lab, int* dist, float* eimg,
           int* changed, int H, int W, int nnb) {
  __shared__ float s_cost[kSide][kSide];
  __shared__ float s_img[kSide][kSide];
  __shared__ int s_lab[2][kSide][kSide];
  __shared__ int s_dist[2][kSide][kSide];
  __shared__ float s_eimg[2][kSide][kSide];
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const long long off = (long long)blockIdx.z * H * W;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < kSide * kSide; i += kTile * kTile) {
    const int ly = i / kSide, lx = i % kSide;
    const int gy = y0 + ly - 1, gx = x0 + lx - 1;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const long long g = off + (long long)gy * W + gx;
    s_cost[ly][lx] = in ? cost[g] : kInf;
    s_img[ly][lx] = in ? img[g] : kInf;
    const int l = in ? lab[g] : kBigLab;
    const int d = in ? dist[g] : kBigLab;
    const float e = in ? eimg[g] : kInf;
    s_lab[0][ly][lx] = s_lab[1][ly][lx] = l;
    s_dist[0][ly][lx] = s_dist[1][ly][lx] = d;
    s_eimg[0][ly][lx] = s_eimg[1][ly][lx] = e;
  }
  const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  const long long g = off + (long long)gy * W + gx;
  bool upd = false;
  if (gy < H && gx < W) {
    const uint8_t f = flags[g];
    upd = (f & kMaskBit) && !(f & kSeedBit);
  }
  __syncthreads();
  const float cp = s_cost[ly][lx];
  const float im = s_img[ly][lx];
  const int l0 = s_lab[0][ly][lx], d0 = s_dist[0][ly][lx];
  const float e0 = s_eimg[0][ly][lx];
  int cur = 0;
  bool again = true;
  for (int step = 0; again && step < kMaxInner; ++step) {
    bool ch = false;
    if (upd) {
      int bd = kBigLab, bl = kBigLab;
      float be = kInf, bs = kInf;
      for (int k = 0; k < nnb; ++k) {
        const int ny = ly + kDy[k], nx = lx + kDx[k];
        const int nl = s_lab[cur][ny][nx];
        const float nc = s_cost[ny][nx];
        if (!((nc > im ? nc : im) == cp) || nl == kBigLab) continue;  // not valid
        const float nim = s_img[ny][nx];
        const bool reset = nc < cp;  // strictly uphill: a new flooding level
        const int nd = s_dist[cur][ny][nx];
        const int cd = reset ? 0 : (nd < kBigLab ? nd + 1 : kBigLab);
        const float ce = reset ? nim : s_eimg[cur][ny][nx];
        const bool take =
            cd < bd || (cd == bd && (ce < be || (ce == be && (nim < bs ||
                                                (nim == bs && nl < bl)))));
        if (take) {
          bd = cd;
          be = ce;
          bs = nim;
          bl = nl;
        }
      }
      const int nxt = cur ^ 1;
      s_lab[nxt][ly][lx] = bl;
      s_dist[nxt][ly][lx] = bd;
      s_eimg[nxt][ly][lx] = be;
      ch = bl != s_lab[cur][ly][lx] || bd != s_dist[cur][ly][lx] ||
           be != s_eimg[cur][ly][lx];
    }
    // one barrier a step: every read of buffer `cur` is done before the
    // next step writes it
    again = __syncthreads_or(ch);
    cur ^= 1;
  }
  const bool mine = upd && (s_lab[cur][ly][lx] != l0 || s_dist[cur][ly][lx] != d0 ||
                            s_eimg[cur][ly][lx] != e0);
  if (mine) {
    lab[g] = s_lab[cur][ly][lx];
    dist[g] = s_dist[cur][ly][lx];
    eimg[g] = s_eimg[cur][ly][lx];
  }
  if (__syncthreads_or(mine) && tid == 0) changed[blockIdx.z] = 1;
}

int check_shape(int B, int H, int W, int connectivity) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || (long long)H * W >= (1ll << 31) ||
      (connectivity != 1 && connectivity != 2))
    return (int)cudaErrorInvalidValue;
  return 0;
}

dim3 grid_of(int B, int H, int W) {
  return dim3((unsigned)((W + kTile - 1) / kTile), (unsigned)((H + kTile - 1) / kTile), B);
}

}  // namespace

// One phase-1 pass over [B, H, W] planes: cost relaxed in place, and
// changed[b] set to 1 for each plane b where it changed (the caller zeroes
// changed before the pass).
extern "C" int pcis_watershed_cost(const void* img, const void* flags, void* cost,
                                   void* changed, int B, int H, int W,
                                   int connectivity, void* stream) {
  if (int e = check_shape(B, H, W, connectivity)) return e;
  cost_pass<<<grid_of(B, H, W), dim3(kTile, kTile), 0, (cudaStream_t)stream>>>(
      (const float*)img, (const uint8_t*)flags, (float*)cost, (int*)changed, H, W,
      connectivity == 2 ? 8 : 4);
  return (int)cudaGetLastError();
}

// One phase-2 pass: (lab, dist, eimg) relaxed in place against the converged
// phase-1 cost; changed as above.
extern "C" int pcis_watershed_label(const void* cost, const void* img, const void* flags,
                                    void* lab, void* dist, void* eimg, void* changed,
                                    int B, int H, int W, int connectivity,
                                    void* stream) {
  if (int e = check_shape(B, H, W, connectivity)) return e;
  label_pass<<<grid_of(B, H, W), dim3(kTile, kTile), 0, (cudaStream_t)stream>>>(
      (const float*)cost, (const float*)img, (const uint8_t*)flags, (int*)lab,
      (int*)dist, (float*)eimg, (int*)changed, H, W, connectivity == 2 ? 8 : 4);
  return (int)cudaGetLastError();
}
