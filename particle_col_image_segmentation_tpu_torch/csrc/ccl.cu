// K2: equal-value connected-component labelling by union-find.
//
// Replaces: particle_col_image_segmentation_tpu/ops/ccl_tiles.py
//   _band_kernel (launched by _make_sweep / _make_init_sweep, driven by
//   min_propagate and ccl_sweeps).
//
// Output contract (same as ops.ccl.connected_components): every pixel holds
// the minimum per-plane linear index (r*W + c) of its component; pixels equal
// to `background` hold -1.  Planes never link to each other.  Like the TPU
// kernel, any two equal values link (the plain fixpoint additionally expects
// values in [0, num_classes)).
//
// Bound on this card: dependent loads in `find` along union-find chains.
// The TPU needed Gauss-Seidel band sweeps because it has no fast scatter or
// atomics; here union-find with min-index roots converges in one pass:
//   1. ccl_local: each block labels a 32x32 tile in shared memory (union by
//      atomicMin, always linking the larger root under the smaller, so the
//      root of a tree is its minimum index), then writes each pixel's tile
//      root as a plane index.  Most links never touch device memory.
//   2. ccl_merge: only pixels whose neighbour lies in another tile union
//      their trees in device memory, with the same atomicMin rule.
//   3. ccl_flatten: every pixel takes its root and background pixels -1.
// Because a tree's root is its minimum member, the result is independent of
// the order in which the atomics land.  The unions of a uniform area build
// long chains (a warp links a whole row at once), so the union phases halve
// every path they walk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;

template <typename V>
__device__ __forceinline__ bool links(V v, int has_bg, int bg) {
  return !(has_bg && (long long)v == (long long)bg);
}

// The union-find below works on tile-local indices in shared memory
// (ccl_local) and on plane indices in device memory (ccl_merge, ccl_flatten).
// Every parent is smaller than its child, so a root is its tree's minimum.

__device__ __forceinline__ int find_root(volatile int* L, int x) {
  int p = L[x];
  while (p != x) {
    x = p;
    p = L[x];
  }
  return x;
}

// find_root that re-points each visited node at its grandparent.  Only for
// the union phases: a store there replaces a parent by an ancestor, which
// keeps every node in its tree.  After the unions it would race with the
// final `label = root` stores of ccl_flatten (a stale grandparent landing on
// a tile root that already holds its root), so ccl_flatten uses find_root.
__device__ __forceinline__ int find_halve(volatile int* L, int x) {
  while (true) {
    const int p = L[x];
    if (p == x) return x;
    const int g = L[p];
    if (g == p) return p;
    L[x] = g;
    x = g;
  }
}

__device__ void unite(int* L, int a, int b) {
  while (true) {
    a = find_halve(L, a);
    b = find_halve(L, b);
    if (a == b) return;
    if (a < b) {
      int t = a;
      a = b;
      b = t;
    }
    // a > b: hang root a under b; if a stopped being a root meanwhile,
    // continue with whatever it was hung under
    int old = atomicMin(&L[a], b);
    if (old == a) return;
    a = old;
  }
}

template <typename V>
__global__ void ccl_local(const V* __restrict__ val, int* __restrict__ lab,
                          int H, int W, int conn8, int has_bg, int bg) {
  __shared__ int L[kTile * kTile];
  __shared__ V S[kTile * kTile];
  __shared__ bool F[kTile * kTile];
  const long long plane = (long long)H * W;
  const V* vp = val + blockIdx.z * plane;
  int* lp = lab + blockIdx.z * plane;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int tx = threadIdx.x;

  for (int ty = threadIdx.y; ty < kTile; ty += kRowsPerPass) {
    const int i = ty * kTile + tx;
    const int r = r0 + ty, c = c0 + tx;
    const bool in = r < H && c < W;
    V v = in ? vp[(long long)r * W + c] : (V)0;
    S[i] = v;
    F[i] = in && links(v, has_bg, bg);
    L[i] = i;
  }
  __syncthreads();

  for (int ty = threadIdx.y; ty < kTile; ty += kRowsPerPass) {
    const int i = ty * kTile + tx;
    if (!F[i]) continue;
    const V v = S[i];
    // earlier neighbours only (left, up-left, up, up-right): every
    // neighbour pair is visited once, from its later member
    if (tx > 0 && F[i - 1] && S[i - 1] == v) unite(L, i, i - 1);
    if (ty > 0) {
      const int u = i - kTile;
      if (F[u] && S[u] == v) unite(L, i, u);
      if (conn8) {
        if (tx > 0 && F[u - 1] && S[u - 1] == v) unite(L, i, u - 1);
        if (tx < kTile - 1 && F[u + 1] && S[u + 1] == v)
          unite(L, i, u + 1);
      }
    }
  }
  __syncthreads();

  for (int ty = threadIdx.y; ty < kTile; ty += kRowsPerPass) {
    const int r = r0 + ty, c = c0 + tx;
    if (r >= H || c >= W) continue;
    const int root = find_root(L, ty * kTile + tx);
    lp[(long long)r * W + c] = (r0 + root / kTile) * W + (c0 + root % kTile);
  }
}

template <typename V>
__global__ void ccl_merge(const V* __restrict__ val, int* lab, int H, int W,
                          int conn8, int has_bg, int bg) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= H || c >= W) return;
  const bool top = r > 0 && r % kTile == 0;
  const bool left = c > 0 && c % kTile == 0;
  const bool right = c + 1 < W && (c + 1) % kTile == 0;
  if (!(top || left || right)) return;
  const long long plane = (long long)H * W;
  const V* vp = val + blockIdx.z * plane;
  int* lp = lab + blockIdx.z * plane;
  const int p = r * W + c;
  const V v = vp[p];
  if (!links(v, has_bg, bg)) return;
  // same earlier-neighbour set as ccl_local, restricted to pairs that
  // straddle a tile edge (pairs inside a tile are already united)
  if (left && vp[p - 1] == v) unite(lp, p, p - 1);
  if (r > 0) {
    const int u = p - W;
    if (top && vp[u] == v) unite(lp, p, u);
    if (conn8) {
      if (c > 0 && (top || left) && vp[u - 1] == v) unite(lp, p, u - 1);
      if (c + 1 < W && (top || right) && vp[u + 1] == v)
        unite(lp, p, u + 1);
    }
  }
}

template <typename V>
__global__ void ccl_flatten(const V* __restrict__ val, int* lab, long long plane,
                            int has_bg, int bg) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  int* lp = lab + blockIdx.y * plane;
  if (has_bg && (long long)val[blockIdx.y * plane + p] == (long long)bg) {
    // background never joins a tree, so no other pixel reads this slot
    lp[p] = -1;
    return;
  }
  lp[p] = find_root(lp, lp[p]);
}

template <typename V>
int launch(const V* val, int* lab, int B, int H, int W, int connectivity,
           int has_bg, int bg, cudaStream_t s) {
  const int conn8 = connectivity == 8;
  dim3 tb(kTile, kRowsPerPass);
  dim3 tg((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  ccl_local<V><<<tg, tb, 0, s>>>(val, lab, H, W, conn8, has_bg, bg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 mb(32, 8);
  dim3 mg((W + 31) / 32, (H + 7) / 8, B);
  ccl_merge<V><<<mg, mb, 0, s>>>(val, lab, H, W, conn8, has_bg, bg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long plane = (long long)H * W;
  dim3 fg((unsigned)((plane + 255) / 256), B);
  ccl_flatten<V><<<fg, 256, 0, s>>>(val, lab, plane, has_bg, bg);
  return (int)cudaGetLastError();
}

int check(int B, int H, int W, int connectivity) {
  if (connectivity != 4 && connectivity != 8) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  // plane indices are int32; grid y of ccl_merge is ceil(H/8), z is B
  if ((long long)H * W >= (1ll << 31) || B > 65535 || (H + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int pcis_ccl_u8(const void* val, void* lab, int B, int H, int W,
                           int connectivity, int has_bg, int bg,
                           void* stream) {
  int e = check(B, H, W, connectivity);
  if (e) return e;
  return launch<uint8_t>((const uint8_t*)val, (int*)lab, B, H, W, connectivity,
                         has_bg, bg, (cudaStream_t)stream);
}

extern "C" int pcis_ccl_i32(const void* val, void* lab, int B, int H, int W,
                            int connectivity, int has_bg, int bg,
                            void* stream) {
  int e = check(B, H, W, connectivity);
  if (e) return e;
  return launch<int32_t>((const int32_t*)val, (int*)lab, B, H, W, connectivity,
                         has_bg, bg, (cudaStream_t)stream);
}
