// K8: one strain's particle-fill step.
//
// Replaces: particle_col_image_segmentation_tpu/ops/fill_tiles.py
//   _fill_kernel (launched by particle_fill_step_pallas, dispatched by
//   particle_fill_step_auto).
//
// Contract (same as ops.fill_tiles.particle_fill_step): with d2 the capped
// squared EDT of the particle mask (img == pval, edt.cuh),
//   overlap = img == sval && (d2 < dt2 || d2 <= dr2)
//   out     = overlap ? pval : img          (a fresh plane: Jacobi)
//   count[b] = #overlap pixels of plane b
//
// Bound on this card: at the analyze default (cap 20) the 41 shared-memory
// taps per pixel of the column pass; the TPU kernel's one-uint8-in,
// one-uint8-out traffic becomes a uint8 read, an int32 scratch round trip
// and a uint8 write.  The design is K9's (edt.cuh) with the fill test as the
// column pass's epilogue, so the squared distances never reach device
// memory; each block sums its overlap count (warp reduce, one shared atomic
// per warp) and adds it to count[b] with one device atomic.

#include "edt.cuh"

namespace {

__global__ void fill_tile(const int* __restrict__ dh2, const uint8_t* __restrict__ img,
                          uint8_t* __restrict__ out, int* __restrict__ count,
                          int H, int W, int cap, int pval, int sval, int dt2,
                          int dr2) {
  __shared__ int s_count;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const long long off = (long long)blockIdx.z * H * W;
  const uint8_t* src = img + off;
  uint8_t* dst = out + off;
  int n = 0;
  auto fill = [&](int r, int c, int d2) {
    const long long p = (long long)r * W + c;
    const int x = src[p];
    const bool ov = x == sval && (d2 < dt2 || d2 <= dr2);
    dst[p] = (uint8_t)(ov ? pval : x);
    n += ov;
  };
  edt::col_tile(dh2 + off, H, W, cap, fill);
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&s_count, n);
  __syncthreads();
  if (threadIdx.x == 0 && s_count) atomicAdd(&count[blockIdx.z], s_count);
}

}  // namespace

extern "C" int pcis_particle_fill(const void* img, void* out, void* count,
                                  void* scratch, int B, int H, int W, int cap,
                                  int pval, int sval, int dt2, int dr2,
                                  void* stream) {
  if (edt::bad_shape(B, H, W, cap) || pval < 0 || pval > 255 || sval < 0 ||
      sval > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int) * (size_t)B, s);
  if (e != cudaSuccess) return (int)e;
  const long long nrows = (long long)B * H;
  int* dh2 = (int*)scratch;
  edt::row_pass<<<edt::row_grid(nrows), edt::kRowWarps * 32, 0, s>>>(
      (const uint8_t*)img, dh2, nrows, W, cap, pval);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fill_tile<<<edt::tile_grid(B, H, W), edt::kWarps * 32, 0, s>>>(
      dh2, (const uint8_t*)img, (uint8_t*)out, (int*)count, H, W, cap, pval,
      sval, dt2, dr2);
  return (int)cudaGetLastError();
}
