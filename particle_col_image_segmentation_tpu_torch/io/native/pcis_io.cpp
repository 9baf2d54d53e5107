// pcis_io — native host-side TIFF I/O of the PyTorch port.
//
// The port's own copy of the JAX package's codec (the same C ABI); it is
// built with g++ under build/pcis_torch_io/ at the checkout root on first
// use (io/native/__init__.py).
//
// The reference's I/O is tifffile/libtiff via Python (split_zstack.py:50,64);
// here the hot path (grayscale TIFF planes feeding the device loader) is a
// small C++ library with a ctypes ABI:
//
//   * read classic and BigTIFF little-endian grayscale 8/16-bit files —
//     uncompressed, LZW (compression 5, incl. horizontal predictor 2) and
//     Deflate (8 / 32946) — in strip or tile layout, single or multi page,
//     straight into a caller buffer;
//   * write single-page uncompressed TIFFs;
//   * a pthread prefetch pool that decodes a list of files ahead of the
//     consumer (overlapping host decode with device compute).
//
// Files are mmap()ed, not slurped: inspect touches only the IFD pages, so
// probing a directory of multi-GB stacks does no bulk I/O (the decode path
// faults in strip data on demand).  Unsupported TIFFs (big-endian, RGB,
// JPEG-compressed, ...) report 0 pages so Python falls back to PIL.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <queue>
#include <atomic>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <zlib.h>

extern "C" {

struct TiffPageInfo {
  uint32_t width;
  uint32_t height;
  uint32_t bits_per_sample;   // 8 or 16
  uint32_t samples_per_pixel; // 1 (grayscale)
};

namespace {

// ---------------------------------------------------------------------------
// lazy file access
// ---------------------------------------------------------------------------

struct Mapped {
  const uint8_t* p = nullptr;
  size_t n = 0;
  bool open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size <= 0) { ::close(fd); return false; }
    void* m = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (m == MAP_FAILED) return false;
    p = (const uint8_t*)m;
    n = (size_t)st.st_size;
    return true;
  }
  ~Mapped() { if (p) munmap((void*)p, n); }
  Mapped() = default;
  Mapped(const Mapped&) = delete;
  Mapped& operator=(const Mapped&) = delete;
};

struct Reader {
  const uint8_t* p;
  size_t n;
  // bounds tests are "off <= n - k" with n >= k, NEVER "off + k <= n":
  // offsets come straight from untrusted TIFF fields (64-bit in BigTIFF)
  // and "off + k" wraps for off near 2^64, passing the check and reading
  // ~2^64 past the mapping
  bool has(uint64_t off, uint64_t k) const { return n >= k && off <= n - k; }
  uint16_t u16(uint64_t off) const {
    return has(off, 2) ? (uint16_t)(p[off] | p[off + 1] << 8) : 0;
  }
  uint32_t u32(uint64_t off) const {
    return has(off, 4)
      ? (uint32_t)(p[off] | p[off + 1] << 8 | p[off + 2] << 16 | (uint32_t)p[off + 3] << 24)
      : 0;
  }
  uint64_t u64(uint64_t off) const {
    return has(off, 8) ? (uint64_t)u32(off) | ((uint64_t)u32(off + 4) << 32) : 0;
  }
};

// ---------------------------------------------------------------------------
// IFD parsing (classic + BigTIFF, little-endian)
// ---------------------------------------------------------------------------

struct Ifd {
  uint32_t width = 0, height = 0, bps = 8, spp = 1, compression = 1;
  uint32_t predictor = 1, fill_order = 1, sample_format = 1;
  uint32_t rows_per_strip = 0xffffffff;
  uint32_t tile_w = 0, tile_h = 0;       // nonzero → tiled layout
  std::vector<uint64_t> seg_offsets, seg_counts;  // strips or tiles
  uint64_t next = 0;
};

// element size per TIFF type id (0 = unsupported for our tags)
inline uint64_t type_size(uint16_t type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;  // BYTE/ASCII/SBYTE/UNDEF
    case 3: case 8: return 2;                  // SHORT
    case 4: case 9: case 11: return 4;         // LONG / FLOAT
    case 16: case 17: return 8;                // LONG8
    default: return 0;
  }
}

// Parse one IFD at offset; `big` selects BigTIFF entry layout.
bool parse_ifd(const Reader& r, uint64_t off, bool big, Ifd* ifd) {
  uint64_t count, base, entry_sz = big ? 20 : 12;
  if (big) {
    if (!r.has(off, 8)) return false;  // wrap-safe (off is untrusted u64)
    count = r.u64(off);
    base = off + 8;
  } else {
    if (!r.has(off, 2)) return false;
    count = r.u16(off);
    base = off + 2;
  }
  if (count > 65536 || base + entry_sz * count + (big ? 8 : 4) > r.n) return false;
  for (uint64_t i = 0; i < count; i++) {
    uint64_t e = base + entry_sz * i;
    uint16_t tag = r.u16(e), type = r.u16(e + 2);
    uint64_t cnt = big ? r.u64(e + 4) : r.u32(e + 4);
    uint64_t vfield = big ? e + 12 : e + 8;
    uint64_t inline_cap = big ? 8 : 4;
    uint64_t elt = type_size(type);
    if (elt == 0) continue;
    uint64_t voff = elt * cnt <= inline_cap
        ? vfield
        : (big ? r.u64(vfield) : (uint64_t)r.u32(vfield));
    auto value_at = [&](uint64_t idx) -> uint64_t {
      uint64_t p = voff + elt * idx;
      switch (elt) {
        case 1: return p < r.n ? r.p[p] : 0;
        case 2: return r.u16(p);
        case 4: return r.u32(p);
        default: return r.u64(p);
      }
    };
    switch (tag) {
      case 256: ifd->width = (uint32_t)value_at(0); break;
      case 257: ifd->height = (uint32_t)value_at(0); break;
      case 258: ifd->bps = (uint32_t)value_at(0); break;
      case 259: ifd->compression = (uint32_t)value_at(0); break;
      case 266: ifd->fill_order = (uint32_t)value_at(0); break;
      case 277: ifd->spp = (uint32_t)value_at(0); break;
      case 278: ifd->rows_per_strip = (uint32_t)value_at(0); break;
      case 317: ifd->predictor = (uint32_t)value_at(0); break;
      case 339: ifd->sample_format = (uint32_t)value_at(0); break;
      case 322: ifd->tile_w = (uint32_t)value_at(0); break;
      case 323: ifd->tile_h = (uint32_t)value_at(0); break;
      case 273: case 324:
        // a legitimate external value array occupies <= file size bytes;
        // an untrusted cnt like 0xffffffff would otherwise drive a 32 GiB
        // resize (bad_alloc -> std::terminate through the C ABI)
        if (cnt > r.n) return false;
        ifd->seg_offsets.resize(cnt);
        for (uint64_t k = 0; k < cnt; k++) ifd->seg_offsets[k] = value_at(k);
        break;
      case 279: case 325:
        if (cnt > r.n) return false;
        ifd->seg_counts.resize(cnt);
        for (uint64_t k = 0; k < cnt; k++) ifd->seg_counts[k] = value_at(k);
        break;
      default: break;
    }
  }
  ifd->next = big ? r.u64(base + entry_sz * count) : (uint64_t)r.u32(base + entry_sz * count);
  return true;
}

// Walk IFD chain; fills pages. Returns false if not a little-endian TIFF.
bool parse_tiff(const Reader& r, std::vector<Ifd>& pages) {
  if (r.n < 8 || r.p[0] != 'I' || r.p[1] != 'I') return false;
  uint16_t magic = r.u16(2);
  bool big = false;
  uint64_t off;
  if (magic == 42) {
    off = r.u32(4);
  } else if (magic == 43) {               // BigTIFF
    if (r.u16(4) != 8 || r.u16(6) != 0 || r.n < 16) return false;
    big = true;
    off = r.u64(8);
  } else {
    return false;
  }
  int guard = 0;
  while (off && guard++ < 65536) {
    Ifd ifd;
    if (!parse_ifd(r, off, big, &ifd)) return false;
    pages.push_back(std::move(ifd));
    off = pages.back().next;
  }
  return !pages.empty();
}

bool page_supported(const Ifd& p) {
  if (p.spp != 1 || (p.bps != 8 && p.bps != 16)) return false;
  if (p.width == 0 || p.height == 0) return false;
  // dimension sanity caps: (uint64)w*h*pix and tile_w*pix*tile_h feed
  // buffer sizes and memcpy destination offsets — untrusted dimensions
  // chosen so the products wrap uint64 would pass the size checks with a
  // tiny wrapped value and then write far out of bounds.  4 Gpx/page and
  // 256 Mpx/tile are far beyond any real microscope export.
  if ((uint64_t)p.width * p.height > (1ull << 32)) return false;
  if ((uint64_t)p.tile_w * p.tile_h > (1ull << 28)) return false;
  if (p.compression != 1 && p.compression != 5 && p.compression != 8 &&
      p.compression != 32946)
    return false;
  if (p.predictor != 1 && p.predictor != 2) return false;
  if (p.fill_order != 1) return false;
  if (p.sample_format != 1) return false;   // unsigned int only
  if (p.seg_offsets.empty() || p.seg_offsets.size() != p.seg_counts.size())
    return false;
  if ((p.tile_w != 0) != (p.tile_h != 0)) return false;
  return true;
}

// ---------------------------------------------------------------------------
// segment decoders
// ---------------------------------------------------------------------------

// TIFF LZW (MSB-first codes, early code-width change).  Returns bytes written
// or SIZE_MAX on malformed input; stops at out_cap (partial final strips are
// legal — callers size out_cap to the segment's logical extent).
size_t lzw_decode(const uint8_t* in, size_t n, uint8_t* out, size_t out_cap) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMax = 4096;
  static thread_local std::vector<uint16_t> prefix(kMax);
  static thread_local std::vector<uint8_t> suffix(kMax), stack(kMax);
  int next_code = kFirst, code_bits = 9;
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  size_t ip = 0, op = 0;
  int prev = -1;
  auto get_code = [&]() -> int {
    while (bitcnt < code_bits) {
      if (ip >= n) return kEoi;
      bitbuf = (bitbuf << 8) | in[ip++];
      bitcnt += 8;
    }
    bitcnt -= code_bits;
    return (int)((bitbuf >> bitcnt) & ((1u << code_bits) - 1));
  };
  auto emit = [&](int code, int* first_byte) -> bool {
    size_t sp = 0;
    while (code >= kFirst) {
      if (sp >= stack.size() || code >= next_code) return false;
      stack[sp++] = suffix[code];
      code = prefix[code];
    }
    if (code < 0 || code > 255) return false;
    *first_byte = code;
    if (op < out_cap) out[op++] = (uint8_t)code;
    while (sp && op < out_cap) out[op++] = stack[--sp];
    return true;
  };
  for (;;) {
    int code = get_code();
    if (code == kEoi) break;
    if (code == kClear) {
      next_code = kFirst;
      code_bits = 9;
      prev = -1;
      continue;
    }
    int first = 0;
    if (prev < 0) {
      if (!emit(code, &first)) return SIZE_MAX;
    } else if (code < next_code) {
      if (!emit(code, &first)) return SIZE_MAX;
      if (next_code < kMax) {
        prefix[next_code] = (uint16_t)prev;
        suffix[next_code] = (uint8_t)first;
        next_code++;
      }
    } else if (code == next_code && next_code < kMax) {
      // KwKwK case: new entry = prev + first(prev)
      int pf = 0;
      size_t save = op;
      if (!emit(prev, &pf)) return SIZE_MAX;
      (void)save;
      if (op < out_cap) out[op++] = (uint8_t)pf;
      prefix[next_code] = (uint16_t)prev;
      suffix[next_code] = (uint8_t)pf;
      next_code++;
      first = pf;
    } else {
      return SIZE_MAX;
    }
    prev = code;
    // TIFF "early change": width bumps one code early
    if (next_code == (1 << code_bits) - 1 && code_bits < 12) code_bits++;
    if (op >= out_cap) break;
  }
  return op;
}

size_t zlib_decode(const uint8_t* in, size_t n, uint8_t* out, size_t out_cap) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return SIZE_MAX;
  zs.next_in = const_cast<uint8_t*>(in);
  zs.avail_in = (uInt)n;
  zs.next_out = out;
  zs.avail_out = (uInt)out_cap;
  int rc = inflate(&zs, Z_FINISH);
  size_t got = zs.total_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END && rc != Z_BUF_ERROR && rc != Z_OK) return SIZE_MAX;
  return got;
}

// Undo horizontal differencing in place: rows of `w` samples, 8 or 16 bit LE.
void undo_predictor2(uint8_t* buf, size_t nbytes, uint32_t w, uint32_t bps) {
  if (bps == 8) {
    size_t rows = nbytes / w;
    for (size_t r = 0; r < rows; r++) {
      uint8_t* row = buf + r * w;
      for (uint32_t c = 1; c < w; c++) row[c] = (uint8_t)(row[c] + row[c - 1]);
    }
  } else {
    size_t row_bytes = (size_t)w * 2, rows = nbytes / row_bytes;
    for (size_t r = 0; r < rows; r++) {
      uint8_t* row = buf + r * row_bytes;
      uint16_t acc;
      memcpy(&acc, row, 2);
      for (uint32_t c = 1; c < w; c++) {
        uint16_t v;
        memcpy(&v, row + c * 2, 2);
        acc = (uint16_t)(acc + v);
        memcpy(row + c * 2, &acc, 2);
      }
    }
  }
}

// Decode one strip/tile into out (out_cap = logical uncompressed bytes for a
// full segment; short final segments are fine).  Returns bytes produced or
// SIZE_MAX on error.  seg_w = samples per row inside the segment (strip: image
// width; tile: tile width) — needed by the predictor.
size_t decode_segment(const Ifd& p, const uint8_t* src, size_t src_n,
                      uint8_t* out, size_t out_cap, uint32_t seg_w) {
  size_t got;
  switch (p.compression) {
    case 1:
      got = src_n < out_cap ? src_n : out_cap;
      memcpy(out, src, got);
      break;
    case 5:
      got = lzw_decode(src, src_n, out, out_cap);
      break;
    default:  // 8 / 32946
      got = zlib_decode(src, src_n, out, out_cap);
      break;
  }
  if (got == SIZE_MAX) return SIZE_MAX;
  if (p.predictor == 2) undo_predictor2(out, got, seg_w, p.bps);
  return got;
}

// Decode a full page into dst (page-major caller layout, row-major pixels).
bool decode_page(const Reader& r, const Ifd& p, uint8_t* dst) {
  uint64_t pix = p.bps / 8;
  uint64_t row_bytes = (uint64_t)p.width * pix;
  uint64_t page_bytes = row_bytes * p.height;
  if (p.tile_w == 0) {
    // strip layout
    uint64_t rps = p.rows_per_strip ? p.rows_per_strip : p.height;
    if (rps > p.height) rps = p.height;
    uint64_t written = 0;
    for (size_t s = 0; s < p.seg_offsets.size() && written < page_bytes; s++) {
      uint64_t off = p.seg_offsets[s], cnt = p.seg_counts[s];
      if (off > r.n || cnt > r.n - off) return false;  // wrap-safe
      uint64_t strip_rows = rps;
      uint64_t rows_left = (page_bytes - written) / row_bytes;
      if (strip_rows > rows_left) strip_rows = rows_left;
      uint64_t cap = strip_rows * row_bytes;
      size_t got = decode_segment(p, r.p + off, cnt, dst + written, cap, p.width);
      if (got == SIZE_MAX || got < cap) return false;
      written += cap;
    }
    return written == page_bytes;
  }
  // tile layout
  uint64_t tiles_x = (p.width + p.tile_w - 1) / p.tile_w;
  uint64_t tiles_y = (p.height + p.tile_h - 1) / p.tile_h;
  if (p.seg_offsets.size() < tiles_x * tiles_y) return false;
  uint64_t tile_row_bytes = (uint64_t)p.tile_w * pix;
  uint64_t tile_bytes = tile_row_bytes * p.tile_h;
  std::vector<uint8_t> tb(tile_bytes);
  for (uint64_t ty = 0; ty < tiles_y; ty++) {
    for (uint64_t tx = 0; tx < tiles_x; tx++) {
      uint64_t s = ty * tiles_x + tx;
      uint64_t off = p.seg_offsets[s], cnt = p.seg_counts[s];
      if (off > r.n || cnt > r.n - off) return false;  // wrap-safe
      size_t got = decode_segment(p, r.p + off, cnt, tb.data(), tile_bytes, p.tile_w);
      if (got == SIZE_MAX || got < tile_bytes) return false;
      uint64_t copy_rows = p.tile_h, copy_cols_b = tile_row_bytes;
      if ((ty + 1) * p.tile_h > p.height) copy_rows = p.height - ty * p.tile_h;
      if ((tx + 1) * p.tile_w > p.width)
        copy_cols_b = ((uint64_t)p.width - tx * p.tile_w) * pix;
      for (uint64_t rr = 0; rr < copy_rows; rr++) {
        uint64_t drow = ty * p.tile_h + rr;
        memcpy(dst + drow * row_bytes + tx * p.tile_w * pix,
               tb.data() + rr * tile_row_bytes, copy_cols_b);
      }
    }
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// public ABI
// ---------------------------------------------------------------------------

// Inspect: returns number of pages (≤0 on error / unsupported) and fills
// info with page-0 geometry.  mmap-backed — touches only IFD bytes, no bulk
// read.  Unsupported files return 0 so Python falls back to PIL.
int pcis_tiff_inspect(const char* path, TiffPageInfo* info) try {
  Mapped m;
  if (!m.open(path)) return -1;
  Reader r{m.p, m.n};
  std::vector<Ifd> pages;
  if (!parse_tiff(r, pages)) return 0;
  for (const auto& p : pages) {
    if (!page_supported(p)) return 0;
    // mixed-geometry multipage files (embedded thumbnails / pyramid levels)
    // would be packed misaligned into the (pages, h0, w0) caller buffer —
    // punt those to the PIL fallback
    if (p.width != pages[0].width || p.height != pages[0].height ||
        p.bps != pages[0].bps)
      return 0;
  }
  info->width = pages[0].width;
  info->height = pages[0].height;
  info->bits_per_sample = pages[0].bps;
  info->samples_per_pixel = pages[0].spp;
  return (int)pages.size();
} catch (...) {  // bad_alloc etc. must not cross the C ABI (std::terminate)
  return -9;
}

// Read all pages into out (caller-allocated: pages*height*width*(bps/8)
// bytes, row-major, page-major).  Returns 0 on success.
int pcis_tiff_read(const char* path, uint8_t* out, uint64_t out_size) try {
  Mapped m;
  if (!m.open(path)) return -1;
  Reader r{m.p, m.n};
  std::vector<Ifd> pages;
  if (!parse_tiff(r, pages)) return -2;
  for (const auto& p : pages)  // same support/geometry guard as inspect
    if (!page_supported(p) || p.width != pages[0].width ||
        p.height != pages[0].height || p.bps != pages[0].bps)
      return -5;
  uint64_t cursor = 0;
  for (const auto& p : pages) {
    uint64_t page_bytes = (uint64_t)p.width * p.height * (p.bps / 8);
    if (cursor + page_bytes > out_size) return -3;
    if (!decode_page(r, p, out + cursor)) return -4;
    cursor += page_bytes;
  }
  return cursor == out_size ? 0 : -3;
} catch (...) {
  return -9;
}

// Write a single-page uncompressed grayscale TIFF (8 or 16 bit).
int pcis_tiff_write(const char* path, const uint8_t* data, uint32_t height,
                    uint32_t width, uint32_t bits_per_sample) {
  if (bits_per_sample != 8 && bits_per_sample != 16) return -1;
  uint64_t nbytes = (uint64_t)height * width * (bits_per_sample / 8);
  // classic TIFF carries 32-bit offsets/counts: a > 4 GiB plane would wrap
  // ifd_off/StripByteCounts into a silently unreadable file.  Writers that
  // big need BigTIFF — reject rather than corrupt.
  if (8 + nbytes + 1 + 110 > 0xffffffffull) return -3;
  // layout: header(8) + data + IFD
  uint32_t data_off = 8;
  uint32_t ifd_off = (uint32_t)(8 + nbytes + (nbytes & 1));  // word-align
  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  bool ok = true;
  auto put = [&](const void* buf, size_t sz) {
    ok = ok && fwrite(buf, 1, sz, f) == sz;
  };
  uint8_t header[8] = {'I', 'I', 42, 0, 0, 0, 0, 0};
  memcpy(header + 4, &ifd_off, 4);
  put(header, 8);
  put(data, nbytes);
  if (nbytes & 1) ok = ok && fputc(0, f) != EOF;

  auto entry = [&](uint16_t tag, uint16_t type, uint32_t cnt, uint32_t val) {
    put(&tag, 2);
    put(&type, 2);
    put(&cnt, 4);
    put(&val, 4);
  };
  uint16_t n = 8;
  put(&n, 2);
  entry(256, 4, 1, width);             // ImageWidth
  entry(257, 4, 1, height);            // ImageLength
  entry(258, 3, 1, bits_per_sample);   // BitsPerSample
  entry(259, 3, 1, 1);                 // Compression = none
  entry(262, 3, 1, 1);                 // Photometric = BlackIsZero
  entry(273, 4, 1, data_off);          // StripOffsets
  entry(278, 4, 1, height);            // RowsPerStrip
  entry(279, 4, 1, (uint32_t)nbytes);  // StripByteCounts
  uint32_t zero = 0;
  put(&zero, 4);  // next IFD
  // short writes (full disk) and close failures must not report success
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : -4;
}

// ---------------------------------------------------------------------------
// threaded prefetch pool
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<std::vector<uint8_t>> results;  // decoded pixel buffers
  std::vector<TiffPageInfo> infos;            // page-0 geometry per item
  std::vector<int> npages;                    // page count per item
  std::vector<int> status;                    // -1 pending, 0 ok, >0 error
  std::queue<size_t> work;
  std::mutex mu;
  std::condition_variable cv_done;
  std::vector<std::thread> threads;
  std::atomic<int> remaining{0};

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::lock_guard<std::mutex> g(mu);
        if (work.empty()) return;
        idx = work.front();
        work.pop();
      }
      TiffPageInfo info{};
      int pages = pcis_tiff_inspect(paths[idx].c_str(), &info);
      int st = 1;
      try {
        if (pages > 0) {
          // page dims are capped by page_supported, so this cannot wrap;
          // the try still guards the (pages × page) allocation itself —
          // a bad_alloc escaping a pool thread would std::terminate
          uint64_t sz = (uint64_t)pages * info.height * info.width *
                        (info.bits_per_sample / 8);
          std::vector<uint8_t> buf(sz);
          if (pcis_tiff_read(paths[idx].c_str(), buf.data(), sz) == 0) {
            st = 0;
            std::lock_guard<std::mutex> g(mu);
            results[idx] = std::move(buf);
          }
        }
      } catch (...) {
        st = 2;
      }
      {
        std::lock_guard<std::mutex> g(mu);
        status[idx] = st;
        infos[idx] = info;
        npages[idx] = pages > 0 ? pages : 0;
      }
      remaining--;
      cv_done.notify_all();
    }
  }
};

void* pcis_prefetch_start(const char** path_array, int n_paths, int n_threads) {
  auto* p = new Prefetcher();
  p->paths.assign(path_array, path_array + n_paths);
  p->results.resize(n_paths);
  p->infos.resize(n_paths);
  p->npages.assign(n_paths, 0);
  p->status.assign(n_paths, -1);
  p->remaining = n_paths;
  for (int i = 0; i < n_paths; i++) p->work.push((size_t)i);
  for (int t = 0; t < n_threads; t++)
    p->threads.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocks until item idx is decoded; returns its byte size (0 on error).
uint64_t pcis_prefetch_wait(void* handle, int idx) {
  auto* p = (Prefetcher*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [&] { return p->status[idx] != -1; });
  return p->status[idx] == 0 ? p->results[idx].size() : 0;
}

// Geometry of a decoded item (valid after wait): page count (0 on error) +
// page-0 info.  Workers record this during decode, so callers need no
// separate up-front inspect pass over the path list.
int pcis_prefetch_geom(void* handle, int idx, TiffPageInfo* info) {
  auto* p = (Prefetcher*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [&] { return p->status[idx] != -1; });
  *info = p->infos[idx];
  return p->status[idx] == 0 ? p->npages[idx] : 0;
}

// Copy decoded bytes for idx into out and free them. Returns 0 on success.
int pcis_prefetch_take(void* handle, int idx, uint8_t* out, uint64_t out_size) {
  auto* p = (Prefetcher*)handle;
  std::lock_guard<std::mutex> g(p->mu);
  if (p->status[idx] != 0 || p->results[idx].size() != out_size) return -1;
  memcpy(out, p->results[idx].data(), out_size);
  p->results[idx].clear();
  p->results[idx].shrink_to_fit();
  return 0;
}

void pcis_prefetch_free(void* handle) {
  auto* p = (Prefetcher*)handle;
  for (auto& t : p->threads) t.join();
  delete p;
}

}  // extern "C"
