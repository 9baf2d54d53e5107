// K10 and K11: the two phases of the marker watershed, one pass each.
//
// Replaces: particle_col_image_segmentation_tpu/ops/watershed_tiles.py
//   _cost_kernel (K10, body _relax_cost) and _label_kernel (K11, body
//   _relax_label), launched by _make_sweep and driven by watershed_sweeps
//   (dispatched by watershed_auto), with their band skipping (_need).
//
// Contract (same as ops.watershed.watershed, whose two fixpoints are unique,
// so any schedule gives the same labels bit for bit):
//   K10, phase 1: cost[p] = min over neighbours n of max(cost[n], img[p]),
//     seeds fixed at img, pixels outside the mask at +INF;
//   K11, phase 2: with cost fixed, each masked non-seed pixel takes the
//     lexicographically least claim (level distance, entry img, claimer img,
//     marker id) over its optimal edges, recomputed from scratch from the
//     neighbours' states; seeds hold (marker, 0, -INF) and every other pixel
//     starts at (BIG, BIG, +INF).
// flags: bit 0 = in mask, bit 1 = seed (seeds lie in the mask).  Pass 1 of a
// phase builds the starting state itself (K10 from flags and img, K11 from
// flags and the markers) and writes every pixel, so the caller allocates
// the state without filling it.
//
// Band mode (the space axis of a mesh, parallel/sharded.py): a plane is a
// row band with one halo row above and below, copied from the neighbouring
// bands.  With `resume`, pass 1 reads the state it is given (the band's
// state after an earlier round) instead of building the starting state,
// still learns each tile's live bit, and writes only the pixels it changed.
// A pixel whose flags are 0 (outside the mask: the halo rows carry no
// flags) is never updatable, so the halo rows are read as neighbours and
// never written.  Both phases then relax the band to its local fixpoint
// under the frozen halo rows; that fixpoint is unique (the justification
// argument of ops/watershed.py with the halo rows as constants), so it
// equals the plain band version's.
//
// Bound on this card: the latency of the tiles the passes run.  A pass reads
// a tile's state once (about 9 B a pixel for K10 and 21 B for K11) and the
// number of passes follows the basins' extent in tiles.  A 256-thread block
// takes a 32x32 output tile of the [B, H, W] planes with a one-pixel halo; a
// warp holds a band of four rows in registers, a lane a column of four
// pixels.  The block relaxes the tile to its local fixpoint in block steps:
// in each, a warp whose band may change (the first step, or a neighbour band
// moved in the step before) relaxes the band to its fixpoint with the rows
// above and below it frozen (shuffles along the rows, a lane's four rows
// down and up in turn, so a front crosses the band in one warp step), then
// one barrier publishes the bands.  K10 is monotone (costs only fall), so its
// bands publish in place; K11 is not (the level reset), so its bands publish
// into the second of two shared buffers (Jacobi between bands) and a reader
// never sees a half-written claim.  The halo stays frozen at its loaded
// values.  Pixels past a plane's edge read as sentinels, so planes never
// leak into each other.  Comparisons are float equalities of values copied
// from img or the sentinels, with no float arithmetic, so no fast-math flag
// may be used.
//
// The pass loop stays on the card.  Pass 1 runs one block a tile: it writes
// the tile's starting state, its live bit (the tile holds a masked non-seed
// pixel, so it can change) and relaxes it if it is live.  A later pass runs
// one wave of blocks over a worklist of tiles that the pass before built:
// a block whose tile changed pushes the tile and its 8 neighbours of the
// same plane (a stamp a tile makes each pushed once a pass), and a listed
// tile runs if it is live.  A pass in which nothing changed leaves an empty
// list, so the passes the host enqueues past the fixpoint cost one wave that
// exits at once.  The host reads, once a chunk of passes, a history of
// per-pass rows (`row`): changed[b] for each plane b, then the tiles run
// and the length of the next pass's list.
//
// Races and tile skipping.  A tile runs in pass 1, and in pass k+1 if it is
// live and it or one of its 8 neighbour tiles changed in pass k (it wrote a
// pixel; after pass 1 a tile writes a pixel only if it changed it, pass 1
// writes every pixel and counts a change against the starting state).  A
// block may read a neighbour tile's state while that tile's block writes it.
// Claim I(k): after pass k, every tile t none of whose 3x3-tile
// neighbourhood changed in pass k is a local fixpoint of the state after
// pass k, i.e. relaxing t against its window (t and its halo) changes
// nothing.  The window lies inside the neighbourhood, so the window holds in
// pass k the values it held before the pass (the starting state for pass 1,
// which pass 1 builds for every window it loads, or with resume the given
// state, which no tile of the neighbourhood overwrote), at every moment of it.
//   - t ran in pass k: it loaded its window during the pass, so it saw those
//     unchanged values, relaxed them and found no change; relaxation is a
//     deterministic function of the window, so t is a local fixpoint of them.
//   - t is not live: it has no pixel that an update may change.
//   - t was skipped in pass k otherwise (k > 1): no tile of its
//     neighbourhood changed in pass k-1, so by I(k-1) t was a local fixpoint
//     after pass k-1, of a window that pass k did not change.
// So a tile skipped in pass k+1 saw (or kept) its neighbours' final values
// of pass k and running it would change nothing.  When no tile of a plane
// changed in pass k, I(k) holds for every tile of it: every pixel satisfies
// its update against its neighbours, which is the plane's unique fixpoint;
// no tile of the plane runs again and the plane reports no change.  Each
// block that changes a pixel sets changed[plane] = 1 (an idempotent store).

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kSide = kTile + 2;  // tile plus a one-pixel halo
constexpr int kRows = 4;          // rows of a band: the pixels a lane holds
constexpr int kBands = kTile / kRows;
constexpr int kThreads = 32 * kBands;
constexpr int kWindowLoads = (kSide * kSide + kThreads - 1) / kThreads;
constexpr int kMaxBlockSteps = 4 * kTile * kTile;  // guards on a tile's steps
constexpr int kMaxDevices = 64;  // devices whose launch wave is cached
constexpr int kMaxWarpSteps = 4 * kTile * kRows;
constexpr float kInf = 3.4e38f;
constexpr int kBigLab = INT_MAX;
constexpr uint8_t kMaskBit = 1;
constexpr uint8_t kSeedBit = 2;
constexpr unsigned kFull = 0xffffffffu;

// The pass row (int32): changed[b] for b < B, then these counts.
constexpr int kRowTiles = 0, kRowNext = 1, kRowClaimed = 2;

struct Pass {
  const int* prev_row;  // the previous pass's row: prev_row[B + kRowNext] = list length
  int* row;             // this pass's row, zeroed by the caller
  const int* list;      // this pass's tiles (not read by pass 1)
  int* next_list;       // the next pass's tiles, pushed by this pass
  int* stamp;           // [tiles]: the last pass a tile was pushed for
  int* live;            // [tiles]: 1 if the tile can change (written by pass 1)
  int pass;             // 1, 2, ...
  int B, H, W, TY, TX;  // planes and tiles a plane (TY x TX)
  bool fresh;           // pass 1 builds the starting state (not resume)
};

// One tile: its index, plane and origin.
struct Tile {
  int t, z, ty, tx;
  long long off;  // the plane's first pixel
  int y0, x0;
};

__device__ __forceinline__ Tile tile_of(const Pass& p, int t) {
  const int per = p.TY * p.TX, z = t / per, ty = (t % per) / p.TX, tx = t % p.TX;
  return Tile{t, z, ty, tx, (long long)z * p.H * p.W, ty * kTile, tx * kTile};
}

// The tiles this block runs: in pass 1 its own (blockIdx.x), later the next
// unclaimed entry of the pass's list (a counter in the pass's row, so a
// block that drew a slow tile does not hold up the ones after it).  Returns
// -1 past the end.  Every thread of the block calls it.
__device__ __forceinline__ int next_tile(const Pass& p, int i, int* s_next) {
  if (p.pass == 1) return i == 0 ? (int)blockIdx.x : -1;
  __syncthreads();  // every thread read the last claim
  if (threadIdx.x == 0) *s_next = atomicAdd(&p.row[p.B + kRowClaimed], 1);
  __syncthreads();
  const int idx = *s_next;
  return idx < p.prev_row[p.B + kRowNext] ? p.list[idx] : -1;
}

// Ends a tile that ran: every thread learns whether it changed; if so, warp 0
// pushes the tile and its neighbours of the same plane onto the next pass's
// list (once each a pass) and sets the plane's flag.
__device__ void tile_done(const Pass& p, const Tile& tile, bool mine) {
  const bool any = __syncthreads_or(mine);
  if (any && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int yy = tile.ty + lane / 3 - 1, xx = tile.tx + lane % 3 - 1;
    const int n = tile.t + (yy - tile.ty) * p.TX + (xx - tile.tx);
    const bool push = lane < 9 && yy >= 0 && yy < p.TY && xx >= 0 && xx < p.TX &&
                      (p.pass == 1 || p.live[n]) && atomicExch(&p.stamp[n], p.pass + 1) != p.pass + 1;
    const unsigned m = __ballot_sync(kFull, push);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&p.row[p.B + kRowNext], __popc(m));
    base = __shfl_sync(kFull, base, 0);
    if (push) p.next_list[base + __popc(m & ((1u << lane) - 1))] = n;
    if (lane == 0) p.row[tile.z] = 1;
  }
}

// Bit r set where row r of this lane's column is a masked non-seed pixel.
__device__ __forceinline__ unsigned updatable(const uint8_t* __restrict__ flags, const Pass& p,
                                              const Tile& tile, int band, int lane) {
  unsigned upd = 0;
  const int x = tile.x0 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = tile.y0 + band * kRows + r;
    if (y < p.H && x < p.W) {
      const uint8_t f = flags[tile.off + (long long)y * p.W + x];
      if ((f & kMaskBit) && !(f & kSeedBit)) upd |= 1u << r;
    }
  }
  return upd;
}

// A K11 pixel's state.
struct Claim {
  int lab, dist;
  float eimg;
};

// The value of the lane to the left (shl) or right (shr) in the warp.
__device__ __forceinline__ float shl(float v) { return __shfl_up_sync(kFull, v, 1); }
__device__ __forceinline__ float shr(float v) { return __shfl_down_sync(kFull, v, 1); }
__device__ __forceinline__ Claim shl(Claim c) {
  return {__shfl_up_sync(kFull, c.lab, 1), __shfl_up_sync(kFull, c.dist, 1),
          __shfl_up_sync(kFull, c.eimg, 1)};
}
__device__ __forceinline__ Claim shr(Claim c) {
  return {__shfl_down_sync(kFull, c.lab, 1), __shfl_down_sync(kFull, c.dist, 1),
          __shfl_down_sync(kFull, c.eimg, 1)};
}

// The eight neighbours of row r of a lane's column, in the order of the
// plain version's offsets: up, down, left, right, up-left, up-right,
// down-left, down-right.  In-band rows come from registers (as they stand in
// this warp step), columns beside the lane by shuffles, everything else from
// the shared window S (band edge rows and the halo columns).  `top` is the
// shared row of the band's first row.  Every lane of the warp calls it with
// the same r.
template <int kConn, typename T, typename Src>
__device__ __forceinline__ void neighbours(const T (&v)[kRows], int r, int top, int lane,
                                           const Src& S, T (&n)[8]) {
  const int row = top + r, col = lane + 1;
  const T left = shl(v[r]);
  const T right = shr(v[r]);
  n[0] = r > 0 ? v[r > 0 ? r - 1 : 0] : S(row - 1, col);
  n[1] = r < kRows - 1 ? v[r < kRows - 1 ? r + 1 : 0] : S(row + 1, col);
  n[2] = lane > 0 ? left : S(row, 0);
  n[3] = lane < 31 ? right : S(row, kSide - 1);
  if (kConn == 2) {
    const T au = v[r > 0 ? r - 1 : 0], ad = v[r < kRows - 1 ? r + 1 : 0];
    const T ul = shl(au), ur = shr(au);
    const T dl = shl(ad), dr = shr(ad);
    n[4] = r > 0 && lane > 0 ? ul : S(row - 1, col - 1);
    n[5] = r > 0 && lane < 31 ? ur : S(row - 1, col + 1);
    n[6] = r < kRows - 1 && lane > 0 ? dl : S(row + 1, col - 1);
    n[7] = r < kRows - 1 && lane < 31 ? dr : S(row + 1, col + 1);
  }
}

__constant__ int kDy[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
__constant__ int kDx[8] = {0, 0, -1, 1, -1, 1, -1, 1};

// The block steps of a tile.  In each, a warp whose neighbour band moved in
// the step before (every warp in the first step; a band that moved ended at
// its own fixpoint) relaxes its band to the band's fixpoint against the
// frozen rows around it, in warp steps that take the four rows top-down and
// bottom-up in turn (`row(r, step)` updates row r in registers and says
// whether it changed; every lane calls it with the same r).  Then
// `publish(step, moved)` stores the band for the other warps and one barrier
// ends the step.  The tile stops after a step in which no band moved.
template <typename Row, typename Publish>
__device__ __forceinline__ void relax_tile(int band, int lane, Row row, Publish publish) {
  __shared__ int s_moved[2][kBands + 2];  // by step parity; a 0 pad at each end
  if (threadIdx.x < 2 * (kBands + 2)) (&s_moved[0][0])[threadIdx.x] = 0;
  __syncthreads();
  bool again = true;
  for (int step = 0; again && step < kMaxBlockSteps; ++step) {
    const int* before = s_moved[(step + 1) & 1];
    bool moved = false;
    if (step == 0 || before[band] || before[band + 2]) {
      for (int ws = 0; ws < kMaxWarpSteps; ++ws) {
        bool ch = false;
        if (ws & 1) {
#pragma unroll
          for (int r = kRows - 1; r >= 0; --r) ch |= row(r, step);
        } else {
#pragma unroll
          for (int r = 0; r < kRows; ++r) ch |= row(r, step);
        }
        if (!__any_sync(kFull, ch)) break;
        moved = true;
      }
    }
    publish(step, moved);
    if (lane == 0) s_moved[step & 1][band + 1] = moved;
    again = __syncthreads_or(moved);
  }
}

template <int kConn>
__global__ void __launch_bounds__(kThreads)
cost_pass(const float* __restrict__ img, const uint8_t* __restrict__ flags, float* cost,
          Pass p) {
  constexpr int nnb = kConn == 2 ? 8 : 4;
  __shared__ float s_cost[kSide][kSide];
  __shared__ int s_next;
  const int tid = threadIdx.x, lane = tid & 31, band = tid >> 5;
  const int H = p.H, W = p.W;
  const bool first = p.pass == 1, fresh = p.fresh;
  int tiles_run = 0;  // thread 0's count
  // the starting cost of a pixel (pass 1): img at seeds, +INF elsewhere
  auto start = [&](long long g) { return (flags[g] & kSeedBit) ? img[g] : kInf; };
  for (int i = 0, t; (t = next_tile(p, i, &s_next)) >= 0; ++i) {
    if (!first && !p.live[t]) continue;
    const Tile tile = tile_of(p, t);
    const int gx = tile.x0 + lane;
    tiles_run += tid == 0;
    const unsigned upd = updatable(flags, p, tile, band, lane);
    if (first) {  // pass 1 learns whether the tile is live (later, listed tiles are)
      const bool live = __syncthreads_or(upd != 0);
      if (tid == 0) p.live[t] = live;
      if (!live) {  // nothing here can change
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int gy = tile.y0 + band * kRows + r;
          if (fresh && gy < H && gx < W) {
            const long long g = tile.off + (long long)gy * W + gx;
            cost[g] = start(g);
          }
        }
        continue;
      }
    }
#pragma unroll
    for (int k = 0; k < kWindowLoads; ++k) {  // one round of loads
      const int j = tid + k * kThreads;
      if (j < kSide * kSide) {
        const int ly = j / kSide, lx = j % kSide;
        const int gy = tile.y0 + ly - 1, hx = tile.x0 + lx - 1;
        const long long g = tile.off + (long long)gy * W + hx;
        const bool in = gy >= 0 && gy < H && hx >= 0 && hx < W;
        s_cost[ly][lx] = !in ? kInf : fresh ? start(g) : cost[g];
      }
    }
    const int top = 1 + band * kRows;
    float c[kRows], c0[kRows], im[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int gy = tile.y0 + band * kRows + r;
      im[r] = gy < H && gx < W ? img[tile.off + (long long)gy * W + gx] : kInf;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) c[r] = c0[r] = s_cost[top + r][lane + 1];
    auto S = [&](int y, int x) { return s_cost[y][x]; };
    auto row = [&](int r, int) {
      float n[8];
      neighbours<kConn>(c, r, top, lane, S, n);
      float best = c[r];
#pragma unroll
      for (int k = 0; k < nnb; ++k) {
        const float v = n[k] > im[r] ? n[k] : im[r];
        best = v < best ? v : best;
      }
      if (((upd >> r) & 1u) && best < c[r]) {
        c[r] = best;
        return true;
      }
      return false;
    };
    auto publish = [&](int, bool moved) {
      if (moved) {  // monotone: a racing reader sees either value
#pragma unroll
        for (int r = 0; r < kRows; ++r) s_cost[top + r][lane + 1] = c[r];
      }
    };
    relax_tile(band, lane, row, publish);
    bool mine = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int gy = tile.y0 + band * kRows + r;
      if (gy < H && gx < W && (fresh || c[r] != c0[r]))
        cost[tile.off + (long long)gy * W + gx] = c[r];
      mine |= c[r] != c0[r];
    }
    tile_done(p, tile, mine);
  }
  if (tiles_run) atomicAdd(&p.row[p.B + kRowTiles], tiles_run);
}

template <int kConn>
__global__ void __launch_bounds__(kThreads, kConn == 1 ? 3 : 2)
label_pass(const float* __restrict__ cost, const float* __restrict__ img,
           const uint8_t* __restrict__ flags, const int* __restrict__ markers, int* lab,
           int* dist, float* eimg, Pass p) {
  constexpr int nnb = kConn == 2 ? 8 : 4;
  __shared__ float s_img[kSide][kSide];
  __shared__ int s_lab[2][kSide][kSide];
  __shared__ int s_dist[2][kSide][kSide];
  __shared__ float s_eimg[2][kSide][kSide];
  __shared__ int s_next;
  const int tid = threadIdx.x, lane = tid & 31, band = tid >> 5, col = lane + 1;
  const int H = p.H, W = p.W;
  const bool first = p.pass == 1, fresh = p.fresh;
  int tiles_run = 0;  // thread 0's count
  // the starting state of a pixel (pass 1): (marker, 0, -INF) at seeds,
  // (BIG, BIG, +INF) elsewhere
  auto start = [&](long long g) {
    return (flags[g] & kSeedBit) ? Claim{markers[g], 0, -kInf} : Claim{kBigLab, kBigLab, kInf};
  };
  auto store = [&](long long g, Claim c) {
    lab[g] = c.lab;
    dist[g] = c.dist;
    eimg[g] = c.eimg;
  };
  // the cost window is staged in s_lab[1] (as float bits) and read only
  // while the edge masks are built
  float(*s_cost)[kSide] = reinterpret_cast<float(*)[kSide]>(&s_lab[1][0][0]);
  for (int i = 0, t; (t = next_tile(p, i, &s_next)) >= 0; ++i) {
    if (!first && !p.live[t]) continue;
    const Tile tile = tile_of(p, t);
    const int gx = tile.x0 + lane;
    tiles_run += tid == 0;
    const unsigned upd = updatable(flags, p, tile, band, lane);
    if (first) {  // pass 1 learns whether the tile is live (later, listed tiles are)
      const bool live = __syncthreads_or(upd != 0);
      if (tid == 0) p.live[t] = live;
      if (!live) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int gy = tile.y0 + band * kRows + r;
          if (fresh && gy < H && gx < W) {
            const long long g = tile.off + (long long)gy * W + gx;
            store(g, start(g));
          }
        }
        continue;
      }
    }
#pragma unroll
    for (int k = 0; k < kWindowLoads; ++k) {  // one round of loads
      const int j = tid + k * kThreads;
      if (j < kSide * kSide) {
        const int ly = j / kSide, lx = j % kSide;
        const int gy = tile.y0 + ly - 1, hx = tile.x0 + lx - 1;
        const bool in = gy >= 0 && gy < H && hx >= 0 && hx < W;
        const long long g = tile.off + (long long)gy * W + hx;
        const Claim c = !in ? Claim{kBigLab, kBigLab, kInf}
                            : fresh ? start(g) : Claim{lab[g], dist[g], eimg[g]};
        s_cost[ly][lx] = in ? cost[g] : kInf;
        s_img[ly][lx] = in ? img[g] : kInf;
        s_lab[0][ly][lx] = c.lab;
        s_dist[0][ly][lx] = s_dist[1][ly][lx] = c.dist;
        s_eimg[0][ly][lx] = s_eimg[1][ly][lx] = c.eimg;
      }
    }
    __syncthreads();
    // the optimal edges (max(cost[n], img[p]) == cost[p]) and the uphill
    // crossings among them (cost[n] < cost[p]) of each pixel, as bit masks
    const int top = 1 + band * kRows;
    unsigned opt[kRows], rst[kRows];
    Claim c[kRows], c0[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float cp = s_cost[top + r][col], im = s_img[top + r][col];
      opt[r] = rst[r] = 0;
#pragma unroll
      for (int k = 0; k < nnb; ++k) {
        const float nc = s_cost[top + r + kDy[k]][col + kDx[k]];
        if ((nc > im ? nc : im) == cp) opt[r] |= 1u << k;
        if (nc < cp) rst[r] |= 1u << k;
      }
      c[r] = c0[r] = {s_lab[0][top + r][col], s_dist[0][top + r][col], s_eimg[0][top + r][col]};
    }
    __syncthreads();  // every read of the staged costs is done
#pragma unroll
    for (int k = 0; k < kWindowLoads; ++k) {
      const int j = tid + k * kThreads;
      if (j < kSide * kSide) (&s_lab[1][0][0])[j] = (&s_lab[0][0][0])[j];
    }
    __syncthreads();
    // block step s reads buffer s & 1 and publishes into the other: every
    // read of a buffer is done (the step's barrier) before a step writes it
    auto row = [&](int r, int step) {
      const int cur = step & 1;
      auto S = [&](int y, int x) {
        return Claim{s_lab[cur][y][x], s_dist[cur][y][x], s_eimg[cur][y][x]};
      };
      Claim n[8];
      neighbours<kConn>(c, r, top, lane, S, n);
      if (!((upd >> r) & 1u)) return false;
      int bd = kBigLab, bl = kBigLab;
      float be = kInf, bs = kInf;
#pragma unroll
      for (int k = 0; k < nnb; ++k) {
        if (!((opt[r] >> k) & 1u) || n[k].lab == kBigLab) continue;
        const float nim = s_img[top + r + kDy[k]][col + kDx[k]];
        const bool reset = (rst[r] >> k) & 1u;  // strictly uphill: a new flooding level
        const int cd = reset ? 0 : (n[k].dist < kBigLab ? n[k].dist + 1 : kBigLab);
        const float ce = reset ? nim : n[k].eimg;
        if (cd < bd || (cd == bd && (ce < be || (ce == be && (nim < bs ||
                                                 (nim == bs && n[k].lab < bl)))))) {
          bd = cd;
          be = ce;
          bs = nim;
          bl = n[k].lab;
        }
      }
      if (bl == c[r].lab && bd == c[r].dist && be == c[r].eimg) return false;
      c[r] = {bl, bd, be};
      return true;
    };
    auto publish = [&](int step, bool) {
      const int nxt = (step + 1) & 1;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s_lab[nxt][top + r][col] = c[r].lab;
        s_dist[nxt][top + r][col] = c[r].dist;
        s_eimg[nxt][top + r][col] = c[r].eimg;
      }
    };
    relax_tile(band, lane, row, publish);
    bool mine = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int gy = tile.y0 + band * kRows + r;
      const bool moved = c[r].lab != c0[r].lab || c[r].dist != c0[r].dist ||
                         c[r].eimg != c0[r].eimg;
      if (gy < H && gx < W && (fresh || moved))
        store(tile.off + (long long)gy * W + gx, c[r]);
      mine |= moved;
    }
    tile_done(p, tile, mine);
  }
  if (tiles_run) atomicAdd(&p.row[p.B + kRowTiles], tiles_run);
}

int check_shape(int B, int H, int W, int connectivity, int pass) {
  const long long tiles = (long long)B * ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  if (B <= 0 || H <= 0 || W <= 0 || (long long)H * W >= (1ll << 31) || tiles >= (1ll << 31) ||
      pass < 1 || pass == INT_MAX || (connectivity != 1 && connectivity != 2))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The scratch `tiles` (int32, 4 per tile: two lists, stamps, live bits) and
// the rows cut into one pass's view; pass k reads list k % 2.
Pass pass_of(const void* prev_row, void* row, void* tiles, int pass, int B, int H, int W,
             int resume) {
  const int TY = (H + kTile - 1) / kTile, TX = (W + kTile - 1) / kTile;
  const long long n = (long long)B * TY * TX;
  int* s = (int*)tiles;
  return Pass{(const int*)prev_row, (int*)row, s + (pass % 2) * n, s + ((pass + 1) % 2) * n,
              s + 2 * n, s + 3 * n, pass, B, H, W, TY, TX, pass == 1 && !resume};
}

// Pass 1: a block a tile.  Later passes: one wave of resident blocks.
// slot names the kernel: 0 and 1 K10 at connectivity 1 and 2, 2 and 3 K11.
template <typename K>
int grid_of(K kernel, int slot, const Pass& p, int* blocks) {
  const long long tiles = (long long)p.B * p.TY * p.TX;
  if (p.pass == 1) {
    *blocks = (int)tiles;
    return 0;
  }
  // the card's SMs times the kernel's resident blocks, cached for each
  // (device, kernel): threads of one process launch on several devices, and
  // two threads that race here store the same value
  static std::atomic<int> waves[kMaxDevices][4];  // 0: not yet
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  int wave = dev < kMaxDevices ? waves[dev][slot].load() : 0;
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      return (int)e;
    if (cudaError_t e =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0))
      return (int)e;
    wave = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) waves[dev][slot].store(wave);
  }
  *blocks = (int)(tiles < wave ? tiles : wave);
  return 0;
}

}  // namespace

// One phase-1 pass over [B, H, W] planes: cost relaxed in place (pass 1
// builds and writes the starting costs itself).  row is this pass's row of
// the history, B + 3 int32, zeroed by the caller: changed[b] = 1 where plane
// b changed; then the tiles run, the length of the next pass's list and the
// count of this pass's list entries claimed.  prev_row is the previous
// pass's row, whose [B + 1] is the length of this pass's list; pass 1 runs a
// block a tile and reads no prev_row.  tiles is the
// phase's int32 scratch, 4 a tile of ceil(H/32) x ceil(W/32) a plane: two
// lists, stamps (zeroed by the caller before pass 1) and live bits.  resume
// (band mode): pass 1 resumes from the costs in `cost` instead of building
// the starting costs.
extern "C" int pcis_watershed_cost(const void* img, const void* flags, void* cost,
                                   const void* prev_row, void* row, void* tiles, int pass,
                                   int B, int H, int W, int connectivity, int resume,
                                   void* stream) {
  if (int e = check_shape(B, H, W, connectivity, pass)) return e;
  const Pass p = pass_of(prev_row, row, tiles, pass, B, H, W, resume);
  auto* k = connectivity == 2 ? cost_pass<2> : cost_pass<1>;
  int blocks = 0;
  if (int e = grid_of(k, connectivity - 1, p, &blocks)) return e;
  k<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const float*)img, (const uint8_t*)flags,
                                                   (float*)cost, p);
  return (int)cudaGetLastError();
}

// One phase-2 pass: (lab, dist, eimg) relaxed in place against the converged
// phase-1 cost (pass 1 builds the starting state from flags and the int32
// markers and writes it, or with resume reads the given state; markers is
// then not read and may be null); rows and scratch as for K10.
extern "C" int pcis_watershed_label(const void* cost, const void* img, const void* flags,
                                    const void* markers, void* lab, void* dist, void* eimg,
                                    const void* prev_row, void* row, void* tiles, int pass,
                                    int B, int H, int W, int connectivity, int resume,
                                    void* stream) {
  if (int e = check_shape(B, H, W, connectivity, pass)) return e;
  const Pass p = pass_of(prev_row, row, tiles, pass, B, H, W, resume);
  auto* k = connectivity == 2 ? label_pass<2> : label_pass<1>;
  int blocks = 0;
  if (int e = grid_of(k, connectivity + 1, p, &blocks)) return e;
  k<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)cost, (const float*)img, (const uint8_t*)flags, (const int*)markers,
      (int*)lab, (int*)dist, (float*)eimg, p);
  return (int)cudaGetLastError();
}
