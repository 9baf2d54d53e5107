// K5: the full per-region table (RegionTable) from compact ids, and K7: its
// first five columns alone (CentroidTable), one run walk for both.
//
// Replaces: particle_col_image_segmentation_tpu/ops/regionprops_tiles.py
//   _table_kernel (K5; launched by _run_table for region_table_mxu,
//   dispatched by region_props_auto) and _centroid_kernel (K7; launched by
//   centroid_sums_mxu, dispatched by centroid_sums_auto).
//
// Contract (same as ops.regionprops.region_props): for table rows i in
// [0, R1) of plane b, over the pixels p = (r, c) with seg[b, p] == i,
//   area  = #p
//   sr_hi = sum(r >> 7), sr_lo = sum(r & 127)   (digit sums, each summed on
//   sc_hi = sum(c >> 7), sc_lo = sum(c & 127)    its own: not a split of
//                                                sum(r), int32)
//   class = floor(sum(val) saturated to int32 / max(area, 1))
//   bbox  = (min r, min c, max r + 1, max c + 1), and (0, 0, 0, 0) on empty
//           rows, where every other column is 0 too.
// Ids outside [0, R1) are dropped.  K5's row_offset is added to every
// pixel's row before its digits and extremes are taken: a plane split into
// row bands over a mesh gives each band's table in the plane's rows (the
// digit sums need the offset a pixel, since (r + off) >> 7 is not
// (r >> 7) + (off >> 7) once digits carry).  A whole plane passes 0; K7
// takes the same offset.  K7 (ops.regionprops.centroid_sums) is
// the first five columns, int32 [5, B, R1]: the table kernel's instance for
// V = NoValues reads no values and keeps no value sums, class or extremes.
//
// Bound on this card: memory, 5 B a pixel for uint8 values (8 for int32; 4
// for K7), plus the table.  The TPU accumulated one-hot int8 matmuls on the
// MXU and ran a second pass over the transposed plane for the column
// extremes.  Here, as in K4 (counts.cu), a thread takes 16 consecutive
// pixels and adds a whole run to the table where the id changes, not a
// pixel:
//   - a run lies in one row: it breaks where the id changes and at every row
//     end (the 16-px groups are aligned in the batch's flat index, so a
//     group crosses rows where W % 16 != 0, and planes where H*W % 16 != 0).
//     A run over columns [c0, c0 + n) of row r adds area n, n*(r >> 7) and
//     n*(r & 127), the column digits summed in registers, and the extremes
//     r, c0, r + 1, c0 + n; a group's row comes from one division, not one
//     a pixel;
//   - each thread's last run goes through one __match_any_sync group a warp,
//     so a region's interior costs one table update a warp per 512 px;
//   - each pixel's id and value are read from device memory once, whatever
//     R1 is: a block keeps a 4096-slot open-addressing table in shared
//     memory keyed by id (a chunk of a bench plane holds a few hundred ids;
//     compact ids are near-contiguous, so id & 4095 rarely collides, and
//     never for R1 <= 4096, refine's table).  A run whose id finds no slot
//     within 8 probes adds straight to the output table with device
//     atomics, so the result is exact for any input, an id a pixel
//     included.  The block then flushes its occupied slots;
//   - extremes are kept so that zero means "none": INT_MAX - min and
//     max + 1, combined by max.  So one memset clears the whole output, and
//     empty rows already read (0, 0, 0, 0);
//   - one wave: about one 1024-thread block an SM over (chunks, planes), so
//     a single plane fills the card too, and each block zeroes and flushes
//     its table once;
//   - three launches a K5 call: the memset, the table, and `finalize`, which
//     decodes the minima, divides the class and writes `valid`; two for K7.
// Every column sum wraps mod 2^32 like the int32 table it lands in.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kRun = 16;         // pixels a thread takes at a time
constexpr int kSlots = 4096;     // shared hash-table slots a block (a power of 2)
constexpr int kProbes = 8;       // slots tried before a run goes to device memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;  // devices whose set-up is cached

// K7's value type: no values, only the five centroid columns.
struct NoValues {};
template <typename V>
constexpr bool kValues = !std::is_same<V, NoValues>::value;  // K5

// Shared columns, kSlots each: the slot's id + 1 (0 = empty), area, the four
// digit sums, then (K5) the four extremes in their zero-based encoding.
enum { kKey, kArea, kSrh, kSrl, kSch, kScl, kMinR, kMinC, kMaxR, kMaxC, kIntCols };
// K5: the int64 value sums, then the int columns; K7: the first six
template <typename V>
constexpr size_t kSmem = kValues<V> ? (size_t)kSlots * (8 + 4 * kIntCols)
                                    : (size_t)kSlots * 4 * (kScl + 1);

// The columns one run (or a warp's merged runs of one id) adds to a row.
struct Add {
  int area, srh, srl, sch, scl;
  unsigned long long v;  // value sum, two's complement
  int ext[4];            // INT_MAX - min r, INT_MAX - min c, max r + 1, max c + 1
};

// The output: int32 cols [6, n] (area, sr_hi, sr_lo, sc_hi, sc_lo, class),
// int32 bbox [n, 4], int64 vsum [n], bool valid [n]; n = B * R1.  K7: cols
// [5, n] alone.
struct Out {
  int* cols;
  int* bbox;
  unsigned long long* vsum;
  bool* valid;
  long long n;
  int R1;
};

template <typename V>
__device__ __forceinline__ void add_cols(int* a, long long stride, int* ext, int ext_stride,
                                         unsigned long long* v, const Add& x) {
  // K7 (V = NoValues) keeps no value sums and no extremes
  atomicAdd(a, x.area);
  atomicAdd(a + stride, x.srh);
  atomicAdd(a + 2 * stride, x.srl);
  atomicAdd(a + 3 * stride, x.sch);
  atomicAdd(a + 4 * stride, x.scl);
  if constexpr (kValues<V>) {
    atomicAdd(v, x.v);
#pragma unroll
    for (int k = 0; k < 4; ++k) atomicMax(ext + k * ext_stride, x.ext[k]);
  }
}

// Add x at id `key` of the block's plane: its shared slot if it has or can
// claim one, else the output row itself.
template <typename V>
__device__ __forceinline__ void add_run(int* s, unsigned long long* sv, const Out& o,
                                        long long row0, int key, const Add& x) {
  volatile int* keys = s;
  int h = key & (kSlots - 1);
  for (int probe = 0; probe < kProbes; ++probe) {
    int k = keys[h];
    if (k == 0) k = atomicCAS(s + h, 0, key + 1);  // 0: claimed here
    if (k == 0 || k == key + 1) {
      add_cols<V>(s + kArea * kSlots + h, kSlots, s + kMinR * kSlots + h, kSlots, sv + h, x);
      return;
    }
    h = (h + 1) & (kSlots - 1);
  }
  const long long g = row0 + key;
  add_cols<V>(o.cols + g, o.n, o.bbox + 4 * g, 1, o.vsum + g, x);
}

// The ids of the 16 px at flat index g (g % 16 == 0); pixels past the
// batch read id -1.  (K4's loader, counts.cu.)
__device__ __forceinline__ void load_ids(const int* __restrict__ seg, long long g, long long n,
                                         bool vec, int (&id)[kRun]) {
  if (vec && g + kRun <= n) {
    const int4* s4 = reinterpret_cast<const int4*>(seg + g);
#pragma unroll
    for (int i = 0; i < kRun / 4; ++i) {
      const int4 a = __ldg(s4 + i);
      id[4 * i] = a.x;
      id[4 * i + 1] = a.y;
      id[4 * i + 2] = a.z;
      id[4 * i + 3] = a.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k) id[k] = g + k < n ? seg[g + k] : -1;
}

// Their values as 32-bit words: four bytes a word for uint8, one value a
// word for int32; pixels past the batch read 0.
template <typename V>
__device__ __forceinline__ void load_vals(const V* __restrict__ val, long long g, long long n,
                                          bool vec, unsigned (&vw)[kRun * sizeof(V) / 4]) {
  if (vec && g + kRun <= n) {
    const uint4* v4 = reinterpret_cast<const uint4*>(val + g);
#pragma unroll
    for (int i = 0; i < kRun * (int)sizeof(V) / 16; ++i) {
      const uint4 b = __ldg(v4 + i);
      vw[4 * i] = b.x;
      vw[4 * i + 1] = b.y;
      vw[4 * i + 2] = b.z;
      vw[4 * i + 3] = b.w;
    }
    return;
  }
  if constexpr (sizeof(V) == 1) {
#pragma unroll
    for (int i = 0; i < kRun / 4; ++i) {
      unsigned w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (g + 4 * i + k < n) w |= (unsigned)val[g + 4 * i + k] << (8 * k);
      vw[i] = w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) vw[k] = g + k < n ? (unsigned)val[g + k] : 0u;
  }
}

template <typename V>
__device__ __forceinline__ long long value_at(const unsigned (&vw)[kRun * sizeof(V) / 4], int k) {
  if constexpr (sizeof(V) == 1) return (vw[k >> 2] >> (8 * (k & 3))) & 0xff;
  else return (long long)(int)vw[k];
}

// The current run of a thread: id (-1: none this launch counts), its row,
// first column, length, column digit sums and value sum.
struct Run {
  int key, r, c0, n, sch, scl;
  long long v;
};

__device__ __forceinline__ Add run_cols(const Run& u) {
  Add x;
  x.area = u.n;
  x.srh = u.n * (u.r >> 7);
  x.srl = u.n * (u.r & 127);
  x.sch = u.sch;
  x.scl = u.scl;
  x.v = (unsigned long long)u.v;
  x.ext[0] = INT_MAX - u.r;
  x.ext[1] = INT_MAX - u.c0;
  x.ext[2] = u.r + 1;
  x.ext[3] = u.c0 + u.n;
  return x;
}

// grid (chunks a plane, planes); block (x, b) takes flat pixels [lo, hi) of
// plane b
template <typename V>
__global__ void __launch_bounds__(kThreads, 1) table_kernel(
    const int* __restrict__ seg, const V* __restrict__ val, Out o, int W, long long plane,
    long long chunk, bool vec, int row_off) {
  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* sv = smem;  // K5: value sums, then the int columns
  int* s = reinterpret_cast<int*>(kValues<V> ? smem + kSlots : smem);
  uint4* all = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < (int)(kSmem<V> / 16); i += kThreads)
    all[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const long long off = blockIdx.y * plane;
  const long long lo = off + blockIdx.x * chunk;
  const long long hi = off + ((blockIdx.x + 1) * chunk < plane ? (blockIdx.x + 1) * chunk : plane);
  const long long n_all = (long long)gridDim.y * plane;
  const long long G0 = lo / kRun, G1 = (hi + kRun - 1) / kRun;
  const long long row0 = (long long)blockIdx.y * o.R1;
  const int lane = threadIdx.x & 31;
  // every thread of the block runs the same number of rounds, so whole
  // warps reach the warp intrinsics together
  for (long long base = G0; base < G1; base += kThreads) {
    const long long G = base + threadIdx.x;
    Run u{-1, 0, 0, 0, 0, 0, 0};
    if (G < G1) {
      int id[kRun];
      unsigned vw[kRun * sizeof(V) / 4];
      load_ids(seg, G * kRun, n_all, vec, id);
      if constexpr (kValues<V>) load_vals<V>(val, G * kRun, n_all, vec, vw);
      // (r, c) of the group's first pixel in plane b, by floor division: a
      // group that starts in the plane before has r < 0 there
      const int p0 = (int)(G * kRun - off);  // in (-16, plane)
      int r = p0 >= 0 ? (int)((unsigned)p0 / (unsigned)W)
                      : -1 - (int)((unsigned)(-p0 - 1) / (unsigned)W);
      int c = p0 - r * W;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const long long p = G * kRun + k;
        const int kk = p >= lo && p < hi && id[k] >= 0 && id[k] < o.R1 ? id[k] : -1;
        long long v = 0;
        if constexpr (kValues<V>) v = value_at<V>(vw, k);
        if (kk == u.key && c != 0) {  // same id, same row
          ++u.n;
          u.v += v;
          u.sch += c >> 7;
          u.scl += c & 127;
        } else {
          if (u.key >= 0) add_run<V>(s, sv, o, row0, u.key, run_cols(u));
          u = Run{kk, r + row_off, c, 1, c >> 7, c & 127, v};
        }
        if (++c == W) {
          c = 0;
          ++r;
        }
      }
    }
    // the last run: lanes with the same id add once, through their lowest lane
    const unsigned peers = __match_any_sync(kFull, u.key);
    const Add mine = run_cols(u);
    Add x;
    x.area = __reduce_add_sync(peers, mine.area);
    x.srh = __reduce_add_sync(peers, mine.srh);
    x.srl = __reduce_add_sync(peers, mine.srl);
    x.sch = __reduce_add_sync(peers, mine.sch);
    x.scl = __reduce_add_sync(peers, mine.scl);
    if constexpr (kValues<V>) {
      if constexpr (sizeof(V) == 1) {
        x.v = __reduce_add_sync(peers, (unsigned)u.v);  // <= 32 * 16 * 255
      } else {  // |sum| < 2^35: 24-bit low digits and the signed rest, each fits 32 lanes
        const unsigned lo24 = __reduce_add_sync(peers, (unsigned)(u.v & 0xffffff));
        const int hi = __reduce_add_sync(peers, (int)(u.v >> 24));
        x.v = (unsigned long long)((long long)hi * (1ll << 24) + lo24);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) x.ext[k] = __reduce_max_sync(peers, mine.ext[k]);
    }
    if (u.key >= 0 && lane == __ffs(peers) - 1) add_run<V>(s, sv, o, row0, u.key, x);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    const int key = s[i];
    if (!key) continue;
    Add x;
    x.area = s[kArea * kSlots + i];
    x.srh = s[kSrh * kSlots + i];
    x.srl = s[kSrl * kSlots + i];
    x.sch = s[kSch * kSlots + i];
    x.scl = s[kScl * kSlots + i];
    if constexpr (kValues<V>) {
      x.v = sv[i];
#pragma unroll
      for (int k = 0; k < 4; ++k) x.ext[k] = s[(kMinR + k) * kSlots + i];
    }
    const long long g = row0 + key - 1;
    add_cols<V>(o.cols + g, o.n, o.bbox + 4 * g, 1, o.vsum + g, x);
  }
}

// class = floor(clamped sum / max(area, 1)); the minima decoded; valid.
// Empty rows hold zeros already.  grid (ceil(R1 / 256), B)
__global__ void finalize(Out o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= o.R1) return;
  const long long g = (long long)blockIdx.y * o.R1 + i;
  const int a = o.cols[g];
  long long sum = (long long)o.vsum[g];
  sum = sum > INT_MAX ? INT_MAX : (sum < INT_MIN ? INT_MIN : sum);
  const long long d = a > 1 ? a : 1;
  long long q = sum / d;
  if (q * d != sum && sum < 0) --q;  // floor, as torch's floor division
  o.cols[5 * o.n + g] = (int)q;
  if (a) {
    o.bbox[4 * g] = INT_MAX - o.bbox[4 * g];
    o.bbox[4 * g + 1] = INT_MAX - o.bbox[4 * g + 1];
  }
  o.valid[g] = a > 0 && i > 0;
}

// The card's SM count, and the table kernel's shared-memory attribute set,
// once a process for each device.
template <typename V>
cudaError_t sms_of(int* sms) {
  static std::atomic<int> cached[kMaxDevices];  // 0: not yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*sms = cached[dev].load()) > 0) return cudaSuccess;
  e = cudaFuncSetAttribute(table_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmem<V>);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices) cached[dev].store(*sms);
  return cudaSuccess;
}

template <typename V>
int launch(const int* seg, const V* val, const Out& o, int B, int W, long long plane,
           int row_off, cudaStream_t s) {
  // one memset clears cols (class included), bbox and vsum: 48 B a row (K7:
  // its five columns, 20 B)
  cudaError_t e = cudaMemsetAsync(o.cols, 0, (kValues<V> ? 48 : 20) * (size_t)o.n, s);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = sms_of<V>(&sms);
  if (e != cudaSuccess) return (int)e;
  // about one block an SM in one wave, each chunk a whole number of groups
  long long per_plane = sms / B > 1 ? sms / B : 1;
  long long chunk = (plane + per_plane - 1) / per_plane;
  chunk = (chunk + kRun - 1) / kRun * kRun;
  per_plane = (plane + chunk - 1) / chunk;
  const bool vec = ((uintptr_t)seg | (uintptr_t)val) % 16 == 0;
  table_kernel<V><<<dim3((unsigned)per_plane, B), kThreads, kSmem<V>, s>>>(seg, val, o, W,
                                                                           plane, chunk, vec,
                                                                           row_off);
  e = cudaGetLastError();
  if (e != cudaSuccess || !kValues<V>) return (int)e;
  finalize<<<dim3((unsigned)((o.R1 + 255) / 256), B), 256, 0, s>>>(o);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int W, int R1) {
  return B <= 0 || B > 65535 || H <= 0 || W <= 0 || (long long)H * W >= (1ll << 31) || R1 <= 0;
}

// the plane's rows must stay int32 (and 0 <= row_off)
bool bad_offset(int H, int row_off) { return row_off < 0 || (long long)row_off + H >= (1ll << 31); }

}  // namespace

// table: one buffer of n = B * R1 rows, 49 B a row: int32 cols [6, n]
// (area, sr_hi, sr_lo, sc_hi, sc_lo, class_id), int32 bbox [n, 4], int64
// value sums [n] (the class's numerators), bool valid [n].  row_off: the
// plane row of the input's first row (0 for a whole plane).
extern "C" int pcis_region_table(const void* seg, const void* val, int val_is_u8, void* table,
                                 int B, int H, int W, int R1, int row_off, void* stream) {
  if (bad_shape(B, H, W, R1) || bad_offset(H, row_off)) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)H * W, n = (long long)B * R1;
  char* t = (char*)table;
  const Out o{(int*)t, (int*)(t + 24 * n), (unsigned long long*)(t + 40 * n),
              (bool*)(t + 48 * n), n, R1};
  cudaStream_t s = (cudaStream_t)stream;
  if (val_is_u8)
    return launch<uint8_t>((const int*)seg, (const uint8_t*)val, o, B, W, plane, row_off, s);
  return launch<int32_t>((const int*)seg, (const int32_t*)val, o, B, W, plane, row_off, s);
}

// K7.  cols: int32 [5, B, R1] (area, sr_hi, sr_lo, sc_hi, sc_lo), zeroed here.
// row_off as for K5: a row band's sums in the plane's rows.
extern "C" int pcis_centroid_sums(const void* seg, void* cols, int B, int H, int W, int R1,
                                  int row_off, void* stream) {
  if (bad_shape(B, H, W, R1) || bad_offset(H, row_off)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * R1;
  const Out o{(int*)cols, nullptr, nullptr, nullptr, n, R1};
  return launch<NoValues>((const int*)seg, nullptr, o, B, W, (long long)H * W, row_off,
                          (cudaStream_t)stream);
}
