// K2: equal-value connected-component labelling by union-find over row runs.
//
// Replaces: particle_col_image_segmentation_tpu/ops/ccl_tiles.py
//   _band_kernel (launched by _make_sweep / _make_init_sweep, driven by
//   min_propagate and ccl_sweeps).
//
// Output contract (same as ops.ccl.connected_components): every pixel holds
// the minimum per-plane linear index (r*W + c) of its component; pixels equal
// to `background` hold -1 and never link.  Planes never link to each other.
// Like the TPU kernel, any two equal values link, negatives included (the
// plain fixpoint additionally expects values in [0, num_classes)).
//
// Bound on this card: the union-find's dependent loads and atomics, not its
// 5 bytes a pixel.  Every caller hands K2 one component that spans every
// tile (the fused pass's background class, the zeros of the merge contexts
// and of the DAPI mask, the EDT²'s zero plateau), so the design counts
// unions and walks, not pixels:
//   1. ccl_local: a 256-thread block labels a 32 x 32 tile in shared
//      memory, a warp a band of four rows (their loads issued together; up
//      to eight blocks an SM).  A warp holds a row; a ballot of "equal to
//      my left neighbour" gives each pixel its run start by a bit scan, and
//      the run start is its parent: no atomics.  Runs of neighbouring rows
//      are united only where a contact begins (rules below).  Inside a band
//      the rows are in registers: a run start that touches the row above in
//      its own column takes the parent of that row's run start by a plain
//      store, and the few other contacts are marked by shuffles and united
//      after one barrier; so a uniform tile makes one atomic union a band.
//      Each pixel then walks to its tile root (a few links), writes it as a
//      plane index, and a bit mask marks the tile roots.
//   2. ccl_merge_rows / ccl_merge_cols: one thread per pixel along a tile
//      edge (not per pixel of the plane) unites the trees in device memory
//      across that edge, with the same rules read along the edge.  A uniform
//      plane makes one union per tile-row edge and one per tile corner.
//   3. ccl_roots: each marked tile root walks to its root once and stores
//      it; ccl_flatten: every pixel then reads its root in two loads (four
//      pixels a thread with 16-byte accesses where the plane allows).
// Unions hang the larger root under the smaller (atomicMin), so a tree's
// root is its minimum member and the result does not depend on the order in
// which the atomics land.
//
// Which unions are made.  For a pixel p with up neighbour u, left neighbour
// l, right neighbour t and up-left / up-right neighbours ul / ur, "p~q"
// meaning equal linking values:
//   p-u   unless l~p and ul~u (then l-ul, one column to the left, joins the
//         same two runs);
//   p-ul  (8-conn.) only if not p~u and not l~p (else p-u with u~ul, or
//         p-l with l-ul, joins them);
//   p-ur  (8-conn.) only if not p~u and not p~t (else p-u with u~ur, or
//         p-t with t-ur; t-ur is then never skipped, since u is not ~ur).
// A skipped pair is joined through pairs one column to the left (or made),
// so by induction over columns every pair is joined.  In ccl_local "l~p"
// holds only inside the tile.  Across a tile-row edge (ccl_merge_rows) it is
// read over the whole row: the l-p link it leans on is a run inside a tile
// or a pair across a tile-column edge, which ccl_merge_cols makes on every
// tile's first row and otherwise skips only where the row above joins the
// same two pixels inside their tiles (induction over rows that stops at the
// tile's first row, so the two edges never lean on each other).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;  // a warp's row segment
constexpr int kTileH = 32;  // rows of a tile
constexpr int kWarps = 8;   // blockDim.y of ccl_local: a warp takes 4 rows in turn
constexpr int kRowsPerWarp = kTileH / kWarps;
constexpr int kThreads = 256;

template <typename V>
__device__ __forceinline__ bool links(V v, int has_bg, int bg) {
  return !(has_bg && (long long)v == (long long)bg);
}

__device__ __forceinline__ bool bit(unsigned w, int i) { return (w >> i) & 1u; }

// The highest lane <= `lane` that does not continue its left neighbour's
// run: the run's first pixel.  `cont` has bit i set where pixel i continues
// the run of pixel i-1 (never bit 0).
__device__ __forceinline__ int run_start(unsigned cont, int lane) {
  return 31 - __clz(~cont & ((2u << lane) - 1u));
}

// Union-find on tile-local indices in shared memory (ccl_local) and on plane
// indices in device memory (the merges, ccl_roots).  Every parent is smaller
// than its child, so a root is its tree's minimum.

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
// keeps every node in its tree.  Once the unions are done, the only stores
// are a node's own final root (ccl_roots, ccl_flatten), which a concurrent
// walker may read or not: both are ancestors.
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
__global__ void __launch_bounds__(kTileW * kWarps)
ccl_local(const V* __restrict__ val, int* __restrict__ lab, unsigned* __restrict__ roots,
          int H, int W, int conn8, int has_bg, int bg) {
  __shared__ int L[kTileH * kTileW];
  __shared__ V S[kWarps * kTileW];     // the last row of each warp's band
  __shared__ unsigned F[kWarps];       // its pixels in the plane and linking
  __shared__ unsigned cont_last[kWarps];  // its pixels continuing their left neighbour's run
  const long long plane = (long long)H * W;
  const V* vp = val + blockIdx.z * plane;
  int* lp = lab + blockIdx.z * plane;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const int lane = threadIdx.x;
  const unsigned full = 0xffffffffu;

  // rows (a warp's band of kRowsPerWarp rows, all loads issued first):
  // each pixel's parent is its run start, and a run start that touches the
  // row above in its own column, inside the band, takes the parent of that
  // row's run start as its own: the union p-u made by a plain store, since
  // p is still a root and the parent lies in u's tree (every parent stays
  // smaller than its child, and chains of such starts stay one link deep).
  // The other unions inside the band are only marked here (`todo`, three
  // bits a row: up, up-left, up-right), from registers and shuffles.
  V v[kRowsPerWarp];
  bool fg[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = r0 + threadIdx.y * kRowsPerWarp + k, c = c0 + lane;
    const bool in = r < H && c < W;
    v[k] = in ? vp[(long long)r * W + c] : (V)0;
    fg[k] = in && links(v[k], has_bg, bg);
  }
  unsigned cont[kRowsPerWarp];  // per row of the band, the same in every lane
  unsigned todo = 0;
  unsigned f_up = 0;
  int parent_up = 0;  // this lane's pixel's parent in the row above
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int ty = threadIdx.y * kRowsPerWarp + k;
    const unsigned f = __ballot_sync(full, fg[k]);
    const int left = __shfl_up_sync(full, (int)v[k], 1);
    const unsigned e =
        __ballot_sync(full, lane > 0 && fg[k] && bit(f, lane - 1) && left == (int)v[k]);
    int parent = ty * kTileW + run_start(e, lane);
    if (k > 0) {
      const unsigned eu = cont[k - 1];
      const int ul = __shfl_up_sync(full, (int)v[k - 1], 1);
      const int ur = __shfl_down_sync(full, (int)v[k - 1], 1);
      const bool up = fg[k] && bit(f_up, lane) && v[k - 1] == v[k];
      const int start_parent = __shfl_sync(full, parent_up, run_start(eu, lane));
      if (up && !bit(e, lane)) parent = start_parent;
      unsigned t = up && bit(e, lane) && !bit(eu, lane);
      if (conn8 && fg[k] && !up) {
        t |= (unsigned)(lane > 0 && !bit(e, lane) && bit(f_up, lane - 1) && ul == (int)v[k]) << 1;
        t |= (unsigned)(lane < kTileW - 1 && !bit(e, lane + 1) && bit(f_up, lane + 1) &&
                        ur == (int)v[k]) << 2;
      }
      todo |= t << (3 * k);
    }
    L[ty * kTileW + lane] = parent;
    cont[k] = e;
    f_up = f;
    parent_up = parent;
  }
  // the band's last row, for the band below
  S[threadIdx.y * kTileW + lane] = v[kRowsPerWarp - 1];
  if (lane == 0) {
    F[threadIdx.y] = f_up;
    cont_last[threadIdx.y] = cont[kRowsPerWarp - 1];
  }
  __syncthreads();

  // runs of neighbouring rows: only where a contact begins.  The band's
  // first row reads the row above (another warp's) from shared memory.
  if (threadIdx.y > 0 && fg[0]) {
    const int w = threadIdx.y - 1;
    const unsigned fu = F[w], eu = cont_last[w], e = cont[0];
    const V* su = &S[w * kTileW];
    const int a = threadIdx.y * kRowsPerWarp * kTileW + run_start(e, lane);
    const int above = (threadIdx.y * kRowsPerWarp - 1) * kTileW;
    if (bit(fu, lane) && su[lane] == v[0]) {
      if (!(bit(e, lane) && bit(eu, lane))) unite(L, a, above + run_start(eu, lane));
    } else if (conn8) {
      if (lane > 0 && !bit(e, lane) && bit(fu, lane - 1) && su[lane - 1] == v[0])
        unite(L, a, above + run_start(eu, lane - 1));
      if (lane < kTileW - 1 && !bit(e, lane + 1) && bit(fu, lane + 1) && su[lane + 1] == v[0])
        unite(L, a, above + run_start(eu, lane + 1));
    }
  }
  if (todo) {
#pragma unroll
    for (int k = 1; k < kRowsPerWarp; ++k) {
      const unsigned t = (todo >> (3 * k)) & 7u;
      if (!t) continue;
      const int ty = threadIdx.y * kRowsPerWarp + k;
      const int a = ty * kTileW + run_start(cont[k], lane);
      const int above = (ty - 1) * kTileW;
      if (t & 1u) unite(L, a, above + run_start(cont[k - 1], lane));
      if (t & 2u) unite(L, a, above + run_start(cont[k - 1], lane - 1));
      if (t & 4u) unite(L, a, above + run_start(cont[k - 1], lane + 1));
    }
  }
  __syncthreads();

  // every pixel walks from its run start to the tile root (a run's pixels
  // walk one path, and a start is one link below its band's first start)
  const int ncol = gridDim.x;
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int ty = threadIdx.y * kRowsPerWarp + k;
    const int r = r0 + ty, c = c0 + lane;
    if (r >= H) break;  // the same for the whole warp
    const int i = ty * kTileW + lane;
    const int root = fg[k] ? find_root(L, ty * kTileW + run_start(cont[k], lane)) : -1;
    const unsigned is_root = __ballot_sync(full, root == i);
    if (c < W)
      lp[(long long)r * W + c] =
          fg[k] ? (r0 + root / kTileW) * W + c0 + root % kTileW : -1;
    if (lane == 0) roots[((long long)blockIdx.z * H + r) * ncol + blockIdx.x] = is_root;
  }
}

// Pairs across the edge above each tile row: p on row r = k*kTileH, u above.
template <typename V>
__global__ void ccl_merge_rows(const V* __restrict__ val, int* lab, int H, int W,
                               int conn8, int has_bg, int bg) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)((H - 1) / kTileH) * W) return;
  const int r = (int)(k / W + 1) * kTileH, c = (int)(k % W);
  const long long plane = (long long)H * W;
  const V* vp = val + blockIdx.z * plane;
  int* lp = lab + blockIdx.z * plane;
  const int p = r * W + c, u = p - W;
  const V v = vp[p];
  if (!links(v, has_bg, bg)) return;
  const bool left = c > 0 && vp[p - 1] == v;
  if (vp[u] == v) {
    if (!(left && vp[u - 1] == v)) unite(lp, p, u);
  } else if (conn8) {
    if (c > 0 && !left && vp[u - 1] == v) unite(lp, p, u - 1);
    if (c + 1 < W && vp[p + 1] != v && vp[u + 1] == v) unite(lp, p, u + 1);
  }
}

// Pairs across the edge left of each tile column: a = (r, c-1), b = (r, c)
// with c = k*kTileW.  Diagonals that also cross a tile-row edge (r on a
// tile's first row) are ccl_merge_rows' pairs.
template <typename V>
__global__ void ccl_merge_cols(const V* __restrict__ val, int* lab, int H, int W,
                               int conn8, int has_bg, int bg) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)((W - 1) / kTileW) * H) return;
  const int c = (int)(k / H + 1) * kTileW, r = (int)(k % H);
  const long long plane = (long long)H * W;
  const V* vp = val + blockIdx.z * plane;
  int* lp = lab + blockIdx.z * plane;
  const int b = r * W + c, a = b - 1;
  const V va = vp[a], vb = vp[b];
  const bool fa = links(va, has_bg, bg), fb = links(vb, has_bg, bg);
  const bool band = r % kTileH != 0;  // rows r-1 and r lie in one tile row
  if (!band) {
    if (fa && va == vb) unite(lp, b, a);
    return;
  }
  const V ua = vp[a - W], ub = vp[b - W];
  if (fa && va == vb) {
    if (!(ua == va && ub == va)) unite(lp, b, a);
  } else if (conn8) {
    if (fb && ua == vb && ub != vb) unite(lp, b, a - W);
    if (fa && ub == va && ua != va) unite(lp, a, b - W);
  }
}

// Each tile root (a bit of `roots`) takes its root.
__global__ void ccl_roots(int* lab, const unsigned* __restrict__ roots, int H, int W,
                          int ncol) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)H * ncol) return;
  unsigned w = roots[blockIdx.z * ((long long)H * ncol) + k];
  int* lp = lab + blockIdx.z * ((long long)H * W);
  const int base = (int)(k / ncol) * W + (int)(k % ncol) * kTileW;
  while (w) {
    const int x = base + __ffs(w) - 1;
    w &= w - 1;
    const int root = find_root(lp, x);
    if (root != x) lp[x] = root;
  }
}

// Every pixel's parent is now a tile root that holds its root (or the root).
// A tile root's own store writes back the value it holds, so a concurrent
// reader sees the same root either way.
__global__ void ccl_flatten(int* lab, long long plane) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  int* lp = lab + blockIdx.y * plane;
  const int t = lp[p];
  if (t < 0) return;
  const int g = lp[t];
  if (g != t) lp[p] = g;
}

// ccl_flatten four pixels a thread, 16-byte loads and stores (planes of a
// multiple of 4 pixels, so every plane starts on a 16-byte boundary).
__global__ void ccl_flatten4(int* lab, long long plane) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * q >= plane) return;
  int* lp = lab + blockIdx.y * plane;
  int4* p4 = reinterpret_cast<int4*>(lp) + q;
  const int4 t = *p4;
  int4 g = t;
  if (t.x >= 0) g.x = lp[t.x];
  if (t.y >= 0) g.y = lp[t.y];
  if (t.z >= 0) g.z = lp[t.z];
  if (t.w >= 0) g.w = lp[t.w];
  if (g.x != t.x || g.y != t.y || g.z != t.z || g.w != t.w) *p4 = g;
}

unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

long long roots_len(int B, int H, int W) {
  return (long long)B * H * ((W + kTileW - 1) / kTileW);
}

template <typename V>
int launch(const V* val, int* lab, unsigned* roots, int B, int H, int W,
           int connectivity, int has_bg, int bg, cudaStream_t s) {
  const int conn8 = connectivity == 8;
  const int ncol = (W + kTileW - 1) / kTileW;
  dim3 tg(ncol, (H + kTileH - 1) / kTileH, B);
  ccl_local<V><<<tg, dim3(kTileW, kWarps), 0, s>>>(val, lab, roots, H, W, conn8,
                                                  has_bg, bg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long row_px = (long long)((H - 1) / kTileH) * W;
  if (row_px > 0) {
    ccl_merge_rows<V><<<dim3(blocks(row_px), 1, B), kThreads, 0, s>>>(
        val, lab, H, W, conn8, has_bg, bg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long col_px = (long long)((W - 1) / kTileW) * H;
  if (col_px > 0) {
    ccl_merge_cols<V><<<dim3(blocks(col_px), 1, B), kThreads, 0, s>>>(
        val, lab, H, W, conn8, has_bg, bg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ccl_roots<<<dim3(blocks((long long)H * ncol), 1, B), kThreads, 0, s>>>(lab, roots, H,
                                                                       W, ncol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long plane = (long long)H * W;
  if (plane % 4 == 0) {  // the wrapper's label tensors start 16-byte aligned
    ccl_flatten4<<<dim3(blocks(plane / 4), B), kThreads, 0, s>>>(lab, plane);
  } else {
    ccl_flatten<<<dim3(blocks(plane), B), kThreads, 0, s>>>(lab, plane);
  }
  return (int)cudaGetLastError();
}

int check(int B, int H, int W, int connectivity, long long scratch_len) {
  if (connectivity != 4 && connectivity != 8) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  // plane indices are int32; grid y of ccl_local is ceil(H/kTileH), B is a
  // grid z (ccl_local, the merges, ccl_roots) or y (ccl_flatten)
  if ((long long)H * W >= (1ll << 31) || B > 65535 || (H + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  if (scratch_len < roots_len(B, H, W)) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

}  // namespace

// int32 words of the tile-root mask that pcis_ccl_* needs as scratch
extern "C" long long pcis_ccl_scratch_len(int B, int H, int W) {
  return roots_len(B, H, W);
}

extern "C" int pcis_ccl_u8(const void* val, void* lab, void* scratch, long long scratch_len,
                           int B, int H, int W, int connectivity, int has_bg, int bg,
                           void* stream) {
  int e = check(B, H, W, connectivity, scratch_len);
  if (e) return e;
  return launch<uint8_t>((const uint8_t*)val, (int*)lab, (unsigned*)scratch, B, H, W,
                         connectivity, has_bg, bg, (cudaStream_t)stream);
}

extern "C" int pcis_ccl_i32(const void* val, void* lab, void* scratch, long long scratch_len,
                            int B, int H, int W, int connectivity, int has_bg, int bg,
                            void* stream) {
  int e = check(B, H, W, connectivity, scratch_len);
  if (e) return e;
  return launch<int32_t>((const int32_t*)val, (int*)lab, (unsigned*)scratch, B, H, W,
                         connectivity, has_bg, bg, (cudaStream_t)stream);
}
