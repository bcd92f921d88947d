// Top-down point binning for Hopper (sm_90a).
//
// Replaces pointnav_vo_tpu/ops/topdown_pallas.py::bin_counts_pallas, which
// counts each image's kept candidate points per (row, col) cell of the
// top-down grid as an int8 one-hot matmul on the TPU's matrix unit.  On the
// GPU the same function is a histogram with data-dependent addresses, so
// this kernel scatters instead of multiplying.
//
// Inputs, per image: P = band * W_in candidate points (100 * 341 = 34,100
// at 341x192), each with an int32 row bin, an int32 column bin and a 1-byte
// keep flag.  Output: float32 [B, h, w] counts, zeroed by the caller.
//
// Bound: memory.  The kernel reads the keep byte of every point and the two
// int32 bins of the kept ones (at most 9 B/point), and the output of 4 B per
// cell is written once; it does no arithmetic worth counting.  All kept:
// at batch 512, 17,459,200 * 9 B + 33,521,664 * 4 B = 291 MB, 87 us at
// 3.35 TB/s; at 32 envs 18.2 MB, 5.4 us.
//
// Design: a grid-stride loop over all B * P points; each kept, in-range
// point adds 1.0f to its cell with atomicAdd.  Float adds of 1.0 are exact
// and independent of order while every count stays below 2^24 (a count is
// at most P = 34,100), so the result equals the plain version bit for bit.
// A shared-memory histogram per image (16-bit counts: 130,944 B at
// 192x341) would take the atomics off device memory; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bin_counts_kernel(const int32_t* __restrict__ pix_r,
                                  const int32_t* __restrict__ pix_c,
                                  const uint8_t* __restrict__ keep,
                                  float* __restrict__ out,
                                  int64_t n_points, int64_t points_per_image,
                                  int h, int w) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_points; i += stride) {
    if (!keep[i]) continue;
    const int r = pix_r[i];
    const int c = pix_c[i];
    if (r < 0 || r >= h || c < 0 || c >= w) continue;
    const int64_t b = i / points_per_image;
    atomicAdd(out + (b * h + r) * (int64_t)w + c, 1.0f);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int bin_counts_launch(const void* pix_r, const void* pix_c,
                                 const void* keep, void* out,
                                 int64_t n_images, int64_t points_per_image,
                                 int h, int w, void* stream) {
  const int64_t n_points = n_images * points_per_image;
  if (n_points > 0) {
    const int threads = 256;
    int64_t blocks = (n_points + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
    bin_counts_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)pix_r, (const int32_t*)pix_c, (const uint8_t*)keep,
        (float*)out, n_points, points_per_image, h, w);
  }
  return (int)cudaGetLastError();
}
