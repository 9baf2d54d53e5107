// K9: capped squared Euclidean distance transform.
//
// Replaces: particle_col_image_segmentation_tpu/ops/edt_tiles.py
//   _edt_kernel (launched by edt_sq_pallas, dispatched by edt_sq_auto).
//
// Contract (same as ops.edt.edt_sq): out[b, r, c] = squared distance from
// (r, c) to the nearest nonzero pixel of feat[b], exact where that distance
// is <= cap and in (cap^2, (cap+1)^2] past it; any H, W >= 1 and 0 <= cap <= 32766
// (cap > H included).  The JAX dispatch used its kernel only for cap > 8 on
// lane-aligned planes; this one serves every cap, so disk dilation (cap 2)
// rides it too.
//
// Design and bound: edt.cuh (a ballot row pass into the int32 scratch
// plane, then 64x32 column tiles staged in shared memory).  At the merge
// radius (cap 2) the scratch plane's HBM round trip bounds it.

#include "edt.cuh"

namespace {

__global__ void edt_store(const int* __restrict__ dh2, int* __restrict__ out,
                          int H, int W, int cap) {
  const long long off = (long long)blockIdx.z * H * W;
  int* dst = out + off;
  auto store = [&](int r, int c, int d2) { dst[(long long)r * W + c] = d2; };
  edt::col_tile(dh2 + off, H, W, cap, store);
}

}  // namespace

extern "C" int pcis_edt_sq(const void* feat, void* out, void* scratch, int B,
                           int H, int W, int cap, void* stream) {
  if (edt::bad_shape(B, H, W, cap)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nrows = (long long)B * H;
  int* dh2 = (int*)scratch;
  edt::row_pass<<<edt::row_grid(nrows), edt::kRowWarps * 32, 0, s>>>(
      (const uint8_t*)feat, dh2, nrows, W, cap, -1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  edt_store<<<edt::tile_grid(B, H, W), edt::kWarps * 32, 0, s>>>(
      dh2, (int*)out, H, W, cap);
  return (int)cudaGetLastError();
}
