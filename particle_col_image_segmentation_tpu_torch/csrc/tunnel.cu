// K12: one Jacobi step of the tunnelled phase 2 of the marker watershed, on
// the basins' quotient graph.
//
// Replaces no TPU kernel: the JAX package runs this phase as XLA code
// (particle_col_image_segmentation_tpu/ops/watershed.py claim_labels with
// basins, its claim_candidates / fold_claim / four segment_min calls), and
// the port's plain version is ops/watershed.py claim_labels(basins=...).
//
// Contract (one step of that loop, step for step): with cost, img, the
// segment ids seg and the level increments inc fixed, a step maps the state
// (lab, dist, eimg) of step k to that of step k + 1:
//   1. every pixel folds the claims of its neighbours (4 or 8, in the plain
//      version's order) lexicographically into (d, e, s, l), as
//      claim_candidates(inc=inc, seg=seg) and fold_claim do: a neighbour n
//      claims p iff max(cost[n], img[p]) == cost[p], lab[n] != BIG and
//      seg[n] != seg[p]; its claim is (0, img[n], img[n], lab[n]) across a
//      strictly uphill edge (cost[n] < cost[p]), else (dist[n] + inc[p] or
//      BIG where dist[n] is BIG, eimg[n], img[n], lab[n]);
//   2. every segment takes the least (d, e, s, l) of its pixels, and each of
//      its pixels adopts that (d, e, l);
//   3. seeds keep (marker, 0, -INF), pixels outside the mask (BIG, BIG, INF).
// A step also sets changed[plane] where some pixel's state differs from
// step k's (float `!=`, so -0.0 equals +0.0).
//
// seg is as ops.watershed.basin_segments gives it: int32 ids unique across
// the batch, a segment of two or more pixels holds only masked non-seed
// pixels, is connected under the step's connectivity, and its id is the
// flat index of one of its pixels (its root).  Every other pixel is a
// segment of its own.
//
// Pixel kinds (tunnel_init, once a call, from the flags and seg's window):
// fixed (a seed or outside the mask: never written again), direct (a
// masked non-seed pixel alone in its segment: step 2 is the identity, so it
// adopts its own fold in pass 1) and basin (in a segment of two or more),
// with two sub-bits: rim (a neighbour lies in another segment: only these
// can hold a claim) and root.
//
// Words and lists.  A warp works on a word: 32 pixels of a row (a lane a
// pixel).  tunnel_init lists, once a call, every word (step 0's list), the
// words that hold a rim or root pixel (`always`) and those that hold a
// basin pixel (`basins`).  A pass runs one wave of blocks whose warps take
// list entries in turn.
//
// The three passes of a step, each a launch (so each reads the finished
// writes of the one before):
//   claim (pass 1), over this step's list and `always`: direct pixels fold
//     and write their new state into the other buffer of the pair (Jacobi:
//     read step k, write step k + 1).  A rim pixel whose fold is not the
//     identity (BIG, INF, INF, BIG) takes the 64-bit atomicMin of its key
//     (d, e) into its segment's slot, after a minimum over the lanes of its
//     warp that share the segment (__match_any_sync, then two
//     __reduce_min_sync), so a long rim does not serialise on one address;
//     it stashes (d, e) and (s, l) (below) and sets its bit in its word of
//     `rim`.
//   tiebreak (pass 2), over `always`: each pixel with its `rim` bit whose
//     (d, e) equals its slot's takes the 64-bit atomicMin of its key (s, l)
//     into the segment's tie slot, with the same warp aggregation.
//   adopt (pass 3), over `basins`: every basin pixel gathers its segment's
//     (d, e) and l and writes them into the other buffer.
// A word in which a pixel changed (pass 1 or 3) pushes itself and its 8
// neighbour words of the plane onto the next step's list, each once a step
// (a stamp a word), and sets changed[plane] (an idempotent store).
//
// Why skipping the unlisted words is exact.  Claim: before step k, state
// buffer k & 1 holds step k's state and the other buffer step k - 1's (for
// k = 0 both hold the start).  Step k writes the other buffer at every
// direct pixel of a listed or `always` word and at every basin pixel.  A
// direct pixel p of a word that is neither (k >= 1) lies in a 3x3-word
// block in which no pixel changed in step k - 1, so p and its neighbours
// hold the same values in steps k - 1 and k: its fold in step k is its fold
// in step k - 1, which is its state in step k, which the other buffer holds
// already.  Fixed pixels never change.  So after step k the buffers hold
// steps k + 1 and k, and a skipped pixel would not have changed.
//
// The atomics are exact in any order: a minimum is commutative and
// associative, and the keys order as the plain loop's comparisons do.
// Lexicographic least (d, e) first, then the least (s, l) among the pixels
// that tie on it, is the lexicographic least (d, e, s, l): exactly the four
// segment minima of the plain version.  A segment none of whose pixels
// holds a claim keeps the identity in both slots, so its pixels adopt (BIG,
// INF, BIG), as the plain minima of identities give.  A word listed twice
// in a step (in the list and in `always`) is worked twice on the same
// inputs: the same stores, the same minima.
//
// Keys (64 bits, compared unsigned): an int32 maps to its bits with the sign
// bit flipped (BIG = INT_MAX stays the largest), a float32 to its bits with
// the sign bit set if positive and all bits flipped if negative, after -0.0
// is taken to +0.0 (`==` holds them equal, and the sign of a zero is never
// observed: eimg enters only comparisons, and the step's output is labels).
// Seeds' -3.4e38 and the sentinel 3.4e38 are finite and map as they are.  A
// relief holding NaN lies outside the contract.  The comparisons of pass 1
// are float comparisons of values copied from img and the sentinels, with no
// float arithmetic, so no fast-math flag may be used.
//
// The slots, with no memset of the whole batch: `slots` holds two (d, e)
// arrays used by step parity and one (s, l) array, indexed by segment id
// and read only at roots.  Step k's atomics go into parity k & 1, which the
// roots reset in pass 1 of step k - 1 (tunnel_init before step 0), while
// pass 3 of step k - 1 read the other parity.  Pass 1 of step k resets the
// tie slot at each root (pass 3 of step k - 1 read it; pass 2 of step k
// fills it) and the root's other-parity slot, to be step k + 1's.  A rim
// pixel's stash: (d, e) in its own entry of the other parity (a root's is
// reset by pass 2 once read) and (s, l) in its own entry of the buffer that
// pass 3 overwrites.  `changed` has two rows of B flags and `counts` two
// list lengths, used by parity; pass 3 zeroes the next step's flags and the
// length of the list pass 1 just read, which the step after next refills.
//
// Bound on this card: bytes, at the pixels a step visits.  Pass 1 reads a
// kind byte and, at a direct or rim pixel, cost, img, inc and the state
// (the neighbours' from cache) and writes the new state: about 37 B.  Pass
// 3 reads and writes about 29 B at a basin pixel.  Unlisted words cost
// nothing, so a step's bytes follow the flood's front and the basins.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;  // devices whose launch wave is cached
constexpr float kInf = 3.4e38f;
constexpr int kBigLab = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;
// the watershed's flags (ops/watershed_tiles.py _flags)
constexpr uint8_t kMaskBit = 1, kSeedBit = 2;
// pixel kinds (tunnel_init)
constexpr uint8_t kDirect = 1, kBasin = 2, kRim = 4, kRoot = 8;
// counts: the two lists' lengths by parity, then `always` and `basins`
constexpr int kAlways = 2, kBasins = 3;

__constant__ int kDy[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
__constant__ int kDx[8] = {0, 0, -1, 1, -1, 1, -1, 1};

__device__ __forceinline__ unsigned int_key(int v) { return (unsigned)v ^ 0x80000000u; }
__device__ __forceinline__ int key_int(unsigned k) { return (int)(k ^ 0x80000000u); }
__device__ __forceinline__ unsigned float_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0;  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
__device__ __forceinline__ u64 pair_key(unsigned hi, unsigned lo) {
  return ((u64)hi << 32) | lo;
}
// the identities of the two slots: (d, e) = (BIG, INF), (s, l) = (INF, BIG)
__device__ __forceinline__ u64 no_de() { return pair_key(int_key(kBigLab), float_key(kInf)); }
__device__ __forceinline__ u64 no_sl() { return pair_key(float_key(kInf), int_key(kBigLab)); }

// One step's view of the buffers.  Step k reads state buffer k & 1 and
// writes the other; `slot` is (d, e) parity k & 1, `other` the other parity.
struct Step {
  const float* cost;
  const float* img;
  const int* inc;
  const int* seg;
  const uint8_t* kind;
  const int* lab;  // step k's state
  const int* dist;
  const float* eimg;
  int* nlab;  // step k + 1's state
  int* ndist;
  float* neimg;
  u64* slot;
  u64* other;
  u64* tie;
  unsigned* rim;       // a bit mask a word: its rim pixels that stashed a claim
  int* changed;        // [B] this step's flags, zero at its start
  int* next_changed;   // [B] the next step's, zeroed by pass 3
  const int* list;     // this step's words
  int* next_list;      // the next step's, pushed by this step
  int* always;         // words with a rim or root pixel
  int* basins;         // words with a basin pixel
  int* stamp;          // [words] the last step + 1 a word was pushed for
  int* counts;         // list lengths: this step's at [cur], the next's at [cur ^ 1]
  int cur, step;
  int B, H, W, WW;     // WW = ceil(W / 32) words a row
  long long words;     // B * H * WW
};

// A warp's 32 pixels are one word of a row: word w, lane -> pixel.
struct Px {
  long long p;  // flat index in the batch
  int z, y, x;
  bool in;
};

__device__ __forceinline__ Px pixel_of(const Step& s, long long w, int lane) {
  const long long zy = w / s.WW;
  const int x = (int)(w % s.WW) * 32 + lane, y = (int)(zy % s.H), z = (int)(zy / s.H);
  return Px{((long long)z * s.H + y) * s.W + x, z, y, x, x < s.W};
}

// A warp's place among the grid's warps, and their number.
__device__ __forceinline__ long long warp_id() {
  return (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
}
__device__ __forceinline__ long long warps() { return (long long)gridDim.x * kWarps; }

// The least of v over the lanes of `group` (all of which call it).
__device__ __forceinline__ u64 group_min(unsigned group, u64 v) {
  const unsigned hi = (unsigned)(v >> 32), lo = (unsigned)v;
  const unsigned mhi = __reduce_min_sync(group, hi);
  const unsigned mlo = __reduce_min_sync(group, hi == mhi ? lo : 0xffffffffu);
  return pair_key(mhi, mlo);
}

// atomicMin of v into slot[id] once for each segment id the warp's `held`
// lanes name (every lane of `held` calls it).
__device__ __forceinline__ void warp_atomic_min(u64* slot, unsigned held, int id, u64 v,
                                                int lane) {
  const unsigned group = __match_any_sync(held, id);
  const u64 m = group_min(group, v);
  if (lane == __ffs(group) - 1) atomicMin(&slot[id], m);
}

// Ends word w (plane z, row y) in which a pixel changed: sets the plane's
// flag and pushes the word and its 8 neighbour words of the plane onto the
// next step's list, each once a step.  Every lane of the warp calls it.
__device__ void word_moved(const Step& s, long long w, int z, int y, int lane) {
  if (lane == 0) s.changed[z] = 1;
  const int xw = (int)(w % s.WW), dy = lane / 3 - 1, dx = lane % 3 - 1;
  const long long n = w + (long long)dy * s.WW + dx;
  const bool push = lane < 9 && y + dy >= 0 && y + dy < s.H && xw + dx >= 0 &&
                    xw + dx < s.WW && atomicExch(&s.stamp[n], s.step + 1) != s.step + 1;
  const unsigned m = __ballot_sync(kFull, push);
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(&s.counts[s.cur ^ 1], __popc(m));
  base = __shfl_sync(kFull, base, 0);
  if (push) s.next_list[base + __popc(m & ((1u << lane) - 1))] = (int)n;
}

struct Fold {
  int d;
  float e, s;
  int l;
};

// Pass 1's fold of the claims onto pixel q.  Direct pixels skip the segment
// test: none of their neighbours shares their segment.
template <int kConn>
__device__ __forceinline__ Fold fold(const Step& s, const Px& q, bool basin, int sp) {
  constexpr int nnb = kConn == 2 ? 8 : 4;
  const float cp = __ldg(&s.cost[q.p]), im = __ldg(&s.img[q.p]);
  const unsigned inc = (unsigned)__ldg(&s.inc[q.p]);
  Fold b{kBigLab, kInf, kInf, kBigLab};
#pragma unroll
  for (int k = 0; k < nnb; ++k) {
    const int ny = q.y - kDy[k], nx = q.x - kDx[k];  // out[r] = x[r - d]
    if (ny < 0 || ny >= s.H || nx < 0 || nx >= s.W) continue;
    const long long n = q.p - (long long)kDy[k] * s.W - kDx[k];
    const float nc = __ldg(&s.cost[n]);
    if ((nc > im ? nc : im) != cp) continue;  // not an optimal edge
    if (basin && __ldg(&s.seg[n]) == sp) continue;
    const int nl = __ldg(&s.lab[n]);
    if (nl == kBigLab) continue;
    const float nim = __ldg(&s.img[n]);
    int cd;
    float ce;
    if (nc < cp) {  // strictly uphill: a new flooding level
      cd = 0;
      ce = nim;
    } else {
      const int nd = __ldg(&s.dist[n]);
      cd = nd < kBigLab ? (int)((unsigned)nd + inc) : kBigLab;  // wraps as int32 does
      ce = __ldg(&s.eimg[n]);
    }
    if (cd < b.d || (cd == b.d && (ce < b.e || (ce == b.e && (nim < b.s ||
                                                (nim == b.s && nl < b.l)))))) {
      b = Fold{cd, ce, nim, nl};
    }
  }
  return b;
}

// A warp a word: both state buffers, the kinds, the roots' slots, the
// stamps, step 0's list (every word), the words of `always` and `basins`,
// and both rows of `changed`.  `counts` arrives zeroed.
template <int kConn>
__global__ void __launch_bounds__(kThreads) tunnel_init(const uint8_t* __restrict__ flags,
                                                        const int* __restrict__ markers,
                                                        const int* __restrict__ seg,
                                                        uint8_t* kind, int* lab, int* dist,
                                                        float* eimg, u64* slots, int* lists,
                                                        int* changed, int* counts, int B,
                                                        int H, int W) {
  constexpr int nnb = kConn == 2 ? 8 : 4;
  const int WW = (W + 31) / 32;
  const long long words = (long long)B * H * WW, N = (long long)B * H * W;
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x; b < 2 * B; b += kThreads) changed[b] = 0;
    if (threadIdx.x == 0) counts[0] = (int)words;
  }
  const long long w = warp_id();
  if (w >= words) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const long long zy = w / WW;
  const int x = (int)(w % WW) * 32 + lane, y = (int)(zy % H);
  const long long p = zy * W + x;
  uint8_t k = 0;
  if (x < W) {
    const uint8_t f = flags[p];
    const bool seeded = f & kSeedBit;
    const int l = seeded ? markers[p] : kBigLab;
    const int d = seeded ? 0 : kBigLab;
    const float e = seeded ? -kInf : kInf;
    lab[p] = lab[N + p] = l;
    dist[p] = dist[N + p] = d;
    eimg[p] = eimg[N + p] = e;
    if ((f & kMaskBit) && !seeded) {
      const int sp = seg[p];
      bool same = false, apart = false;
#pragma unroll
      for (int j = 0; j < nnb; ++j) {
        const int ny = y - kDy[j], nx = x - kDx[j];
        if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
        const int sn = seg[p - (long long)kDy[j] * W - kDx[j]];
        same |= sn == sp;
        apart |= sn != sp;
      }
      if (sp != p || same) {
        k = kBasin | (apart ? kRim : 0);
        if (sp == p) {
          k |= kRoot;
          slots[p] = slots[N + p] = no_de();
          slots[2 * N + p] = no_sl();
        }
      } else {
        k = kDirect;
      }
    }
    kind[p] = k;
  }
  const bool always = __any_sync(kFull, k & (kRim | kRoot));
  const bool basin = __any_sync(kFull, k & kBasin);
  if (lane == 0) {
    lists[w] = (int)w;  // step 0's list
    lists[4 * words + w] = 0;  // the stamp
    if (always) lists[2 * words + atomicAdd(&counts[kAlways], 1)] = (int)w;
    if (basin) lists[3 * words + atomicAdd(&counts[kBasins], 1)] = (int)w;
  }
}

template <int kConn>
__global__ void __launch_bounds__(kThreads) tunnel_claim(Step s) {
  const int lane = threadIdx.x & 31;
  const long long listed = s.counts[s.cur], n = listed + s.counts[kAlways];
  for (long long i = warp_id(); i < n; i += warps()) {  // whole warps
    const long long w = i < listed ? s.list[i] : s.always[i - listed];
    const Px q = pixel_of(s, w, lane);
    const uint8_t k = q.in ? __ldg(&s.kind[q.p]) : 0;
    bool changed = false, stash = false;
    int sp = 0;
    u64 de = 0;
    if (k & (kDirect | kRim)) {
      const bool basin = k & kRim;
      if (basin) sp = __ldg(&s.seg[q.p]);
      const Fold c = fold<kConn>(s, q, basin, sp);
      if (!basin) {
        changed = c.l != __ldg(&s.lab[q.p]) || c.d != __ldg(&s.dist[q.p]) ||
                  c.e != __ldg(&s.eimg[q.p]);
        s.nlab[q.p] = c.l;
        s.ndist[q.p] = c.d;
        s.neimg[q.p] = c.e;
      } else if (c.d != kBigLab || c.e != kInf || c.s != kInf || c.l != kBigLab) {
        stash = true;
        de = pair_key(int_key(c.d), float_key(c.e));
        s.other[q.p] = de;
        s.nlab[q.p] = (int)float_key(c.s);  // pass 3 overwrites both
        s.ndist[q.p] = (int)int_key(c.l);
      }
    }
    if (k & kRoot) {
      s.tie[q.p] = no_sl();
      if (!stash) s.other[q.p] = no_de();  // else pass 2 resets it once read
    }
    const unsigned held = __ballot_sync(kFull, stash);
    if (lane == 0) s.rim[w] = held;
    if (stash) warp_atomic_min(s.slot, held, sp, de, lane);
    if (__any_sync(kFull, changed)) word_moved(s, w, q.z, q.y, lane);
  }
}

__global__ void __launch_bounds__(kThreads) tunnel_tiebreak(Step s) {
  const int lane = threadIdx.x & 31;
  const long long n = s.counts[kAlways];
  for (long long i = warp_id(); i < n; i += warps()) {  // whole warps
    const long long w = s.always[i];
    const unsigned held = s.rim[w];
    const Px q = pixel_of(s, w, lane);
    bool tied = false;
    int sp = 0;
    u64 sl = 0;
    if ((held >> lane) & 1u) {
      sp = __ldg(&s.seg[q.p]);
      tied = s.other[q.p] == __ldg(&s.slot[sp]);
      if (sp == q.p) s.other[q.p] = no_de();  // a root's stash, read: next step's slot
      sl = pair_key((unsigned)s.nlab[q.p], (unsigned)s.ndist[q.p]);
    }
    const unsigned ties = __ballot_sync(kFull, tied);
    if (tied) warp_atomic_min(s.tie, ties, sp, sl, lane);
  }
}

__global__ void __launch_bounds__(kThreads) tunnel_adopt(Step s) {
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x; b < s.B; b += kThreads) s.next_changed[b] = 0;
    if (threadIdx.x == 0) s.counts[s.cur] = 0;  // read by pass 1; refilled by the next step
  }
  const int lane = threadIdx.x & 31;
  const long long n = s.counts[kBasins];
  for (long long i = warp_id(); i < n; i += warps()) {  // whole warps
    const long long w = s.basins[i];
    const Px q = pixel_of(s, w, lane);
    const uint8_t k = q.in ? __ldg(&s.kind[q.p]) : 0;
    bool changed = false;
    if (k & kBasin) {
      const int sp = __ldg(&s.seg[q.p]);
      const u64 de = __ldg(&s.slot[sp]);
      const int l = key_int((unsigned)__ldg(&s.tie[sp]));
      const int d = key_int((unsigned)(de >> 32));
      const float e = key_float((unsigned)de);
      changed = l != __ldg(&s.lab[q.p]) || d != __ldg(&s.dist[q.p]) ||
                e != __ldg(&s.eimg[q.p]);
      s.nlab[q.p] = l;
      s.ndist[q.p] = d;
      s.neimg[q.p] = e;
    }
    if (__any_sync(kFull, changed)) word_moved(s, w, q.z, q.y, lane);
  }
}

int check_shape(int B, int H, int W, int connectivity) {
  if (B <= 0 || H <= 0 || W <= 0 || (long long)B * H * W >= (1ll << 31) ||
      (connectivity != 1 && connectivity != 2))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The view of step `step` (0, 1, ...) over the call's buffers: state pairs
// [2, N], slots [3, N] (two (d, e) parities, then (s, l)), lists [5, words]
// (two lists by parity, `always`, `basins`, the stamps), changed [2, B].
Step step_of(const void* cost, const void* img, const void* inc, const void* seg,
             const void* kind, void* lab, void* dist, void* eimg, void* slots, void* rim,
             void* lists, void* changed, void* counts, int step, int B, int H, int W) {
  const long long N = (long long)B * H * W;
  const int cur = step & 1, nxt = cur ^ 1, WW = (W + 31) / 32;
  const long long words = (long long)B * H * WW;
  int* l = (int*)lab;
  int* d = (int*)dist;
  float* e = (float*)eimg;
  u64* k = (u64*)slots;
  int* c = (int*)changed;
  int* L = (int*)lists;
  return Step{(const float*)cost, (const float*)img, (const int*)inc, (const int*)seg,
              (const uint8_t*)kind, l + cur * N, d + cur * N, e + cur * N,
              l + nxt * N, d + nxt * N, e + nxt * N, k + cur * N, k + nxt * N, k + 2 * N,
              (unsigned*)rim, c + cur * B, c + nxt * B, L + cur * words, L + nxt * words,
              L + 2 * words, L + 3 * words, L + 4 * words, (int*)counts, cur, step,
              B, H, W, WW, words};
}

// One wave of resident blocks of `kernel` on the current device, cached for
// each (device, slot): threads of one process launch on several devices,
// and two threads that race here store the same value.
template <typename K>
int wave_of(K kernel, int slot, int* blocks) {
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
  *blocks = wave;
  return 0;
}

}  // namespace

// Before step 0: both halves of the state pairs lab, dist (int32) and eimg
// (float32), [2, B, H, W], from the watershed's flags (bit 0 in the mask,
// bit 1 a seed) and the int32 markers; the uint8 pixel kinds [B, H, W] from
// the flags and the int32 seg; the roots' entries of `slots` (int64
// [3, B, H, W]); in `lists` (int32 [5, B * H * ceil(W / 32)]) step 0's list,
// `always`, `basins` and the stamps; both rows of `changed` (int32 [2, B])
// zeroed.  `counts` (int32 [4]) must arrive zeroed.
extern "C" int pcis_tunnel_init(const void* flags, const void* markers, const void* seg,
                                void* kind, void* lab, void* dist, void* eimg, void* slots,
                                void* lists, void* changed, void* counts, int B, int H, int W,
                                int connectivity, void* stream) {
  if (int e = check_shape(B, H, W, connectivity)) return e;
  auto* k = connectivity == 2 ? tunnel_init<2> : tunnel_init<1>;
  const long long words = (long long)B * H * ((W + 31) / 32);
  k<<<(int)((words + kWarps - 1) / kWarps), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)flags, (const int*)markers, (const int*)seg, (uint8_t*)kind, (int*)lab,
      (int*)dist, (float*)eimg, (u64*)slots, (int*)lists, (int*)changed, (int*)counts, B, H,
      W);
  return (int)cudaGetLastError();
}

// Step `step` (0, 1, ...): three launches on `stream` that read state
// buffer step & 1 and write the other, and set row step & 1 of `changed`
// where a plane changed, then an asynchronous copy of that row into
// `host_flags` (int32 [B], page-locked host memory): the caller waits on
// the stream and reads it there.  rim is int32 scratch, a word per 32
// pixels of a row.  cost, img (float32), inc and seg (int32) are [B, H, W];
// the rest as pcis_tunnel_init and the steps before left them.
extern "C" int pcis_tunnel_step(const void* cost, const void* img, const void* inc,
                                const void* seg, const void* kind, void* lab, void* dist,
                                void* eimg, void* slots, void* rim, void* lists, void* changed,
                                void* counts, int step, int B, int H, int W, int connectivity,
                                void* stream, void* host_flags) {
  if (int e = check_shape(B, H, W, connectivity)) return e;
  if (step < 0 || step == INT_MAX) return (int)cudaErrorInvalidValue;
  const Step s = step_of(cost, img, inc, seg, kind, lab, dist, eimg, slots, rim, lists,
                         changed, counts, step, B, H, W);
  const cudaStream_t st = (cudaStream_t)stream;
  auto* claim = connectivity == 2 ? tunnel_claim<2> : tunnel_claim<1>;
  int blocks = 0;
  if (int e = wave_of(claim, connectivity - 1, &blocks)) return e;
  claim<<<blocks, kThreads, 0, st>>>(s);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (int e = wave_of(tunnel_tiebreak, 2, &blocks)) return e;
  tunnel_tiebreak<<<blocks, kThreads, 0, st>>>(s);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (int e = wave_of(tunnel_adopt, 3, &blocks)) return e;
  tunnel_adopt<<<blocks, kThreads, 0, st>>>(s);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  return (int)cudaMemcpyAsync(host_flags, (const int*)changed + (step & 1) * B,
                              (size_t)B * sizeof(int), cudaMemcpyDeviceToHost, st);
}
