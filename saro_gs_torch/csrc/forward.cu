// K1, the forward compositor: per-tile front-to-back alpha compositing
// (the reference's renderCUDA, forward.cu:261-393).
//
// Replaces the TPU kernel saro_gs_tpu/ops/tile_kernels.py:_fwd_kernel
// (with _per_tile_steps and _packed_step, entered through
// forward_tiles_pallas).  The TPU version evaluates a [chunk, pixels]
// alpha matrix per step and turns the transmittance recurrence into prefix
// products (roll or matmul), because its vector unit wants dense matrices.
// On Hopper each pixel is a thread and walks its tile's depth-sorted range
// sequentially, which is the plain semantics with no reassociation.
//
// Design: one block per tile, one thread per pixel (tile_x * tile_y
// threads, up to 1024).  The block walks its [start, start + count) range
// of the staged table in batches of `chunk` instances that it first copies
// to shared memory (10 floats each), as forward.cu does.  A block stops
// early once every pixel's walk has ended (__syncthreads_count).
//
// Bound on H100: operations.  Each evaluated instance-pixel pair costs
// about 15 flops and an expf; the bytes (10 words per instance, read once
// per tile, plus 5 words per pixel written) are far fewer.  The design does
// nothing yet about the idle lanes of pixels whose walks ended while their
// block goes on, nor about the imbalance between full and empty tiles.
//
// Semantics (held bit for bit to compositing.composite_tiles, which is
// written in this file's order of operations; built with -fmad=false):
//  * alpha = min(0.99, opacity * expf(min(power, 0))); an instance counts
//    only where alpha >= 1/255 and power <= 0;
//  * broken-conic guard: power > 0 (an indefinite conic) is skipped, as in
//    forward.cu:310 and saro_gs_tpu/ops/tile_kernels.py:100-124;
//  * termination latch: the instance that would take T below 1e-4 does NOT
//    contribute, and the pixel's walk ends there
//    (saro_gs_tpu/ops/tile_kernels.py:554-556);
//  * median depth: the depth of the contributing instance at which T
//    crosses 0.5, else 15.0 (not a weighted mean);
//  * colour = C + T * bg; n_contrib = 1-based rank of the last contributor.
// Pixel coordinates are the integer pixel indices (no +0.5).

// The staging of a batch and the per-instance alpha evaluation live in
// alpha_chain.cuh, shared with the backward replay (backward.cu).

#include <cuda_runtime.h>

#include "alpha_chain.cuh"

namespace {

using saro::kRows;

__global__ void __launch_bounds__(1024)
forward_kernel(const int* __restrict__ tile_start,
               const int* __restrict__ tile_count,
               const float* __restrict__ attr, int L, int width, int height,
               int grid_x, int tile_x, int tile_y, int chunk,
               const float* __restrict__ bg, float* __restrict__ color,
               float* __restrict__ depth_out, float* __restrict__ final_t,
               int* __restrict__ n_contrib) {
  extern __shared__ float sh[];   // [kRows][chunk]

  const int t = blockIdx.x;
  const int lx = threadIdx.x % tile_x;
  const int ly = threadIdx.x / tile_x;
  const int px = (t % grid_x) * tile_x + lx;
  const int py = (t / grid_x) * tile_y + ly;
  const bool inside = px < width && py < height;
  const float pxf = (float)px;
  const float pyf = (float)py;
  const int start = tile_start[t];
  const int count = tile_count[t];

  float T = 1.0f;
  float C0 = 0.0f, C1 = 0.0f, C2 = 0.0f;
  float D = 15.0f;
  int nc = 0;
  bool done = !inside;

  for (int b0 = 0; b0 < count; b0 += chunk) {
    // the whole block leaves once no pixel is still walking
    if (__syncthreads_count(done) == (int)blockDim.x) break;
    const int nb = min(chunk, count - b0);
    saro::stage_batch(sh, attr, L, start + b0, nb, chunk);
    __syncthreads();
    if (!done) {
      for (int j = 0; j < nb; ++j) {
        // broken-conic guard (power > 0 skips) and the 1/255 cutoff; a NaN
        // fails both comparisons and is skipped too
        saro::Splat s;
        if (!saro::eval_alpha(sh, chunk, j, pxf, pyf, s)) continue;
        const float test_t = T * (1.0f - s.alpha);
        if (test_t < saro::kTEps) {   // termination latch: no contribution
          done = true;
          break;
        }
        const float w = s.alpha * T;
        C0 = C0 + w * sh[6 * chunk + j];
        C1 = C1 + w * sh[7 * chunk + j];
        C2 = C2 + w * sh[8 * chunk + j];
        if (T > 0.5f && test_t < 0.5f) D = sh[9 * chunk + j];  // median
        nc = b0 + j + 1;
        T = test_t;
      }
    }
    __syncthreads();   // the next batch overwrites shared memory
  }

  if (inside) {
    const size_t hw = (size_t)height * width;
    const size_t pix = (size_t)py * width + px;
    color[pix] = C0 + T * bg[0];
    color[hw + pix] = C1 + T * bg[1];
    color[2 * hw + pix] = C2 + T * bg[2];
    depth_out[pix] = D;
    final_t[pix] = T;
    if (n_contrib != nullptr) n_contrib[pix] = nc;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  n_contrib may be
// null (need_aux=False).
extern "C" int saro_forward_tiles(const void* tile_start,
                                  const void* tile_count, const void* attr,
                                  int L, int width, int height, int grid_x,
                                  int grid_y, int tile_x, int tile_y,
                                  int chunk, const void* bg, void* color,
                                  void* depth, void* final_t, void* n_contrib,
                                  void* stream) {
  const int blocks = grid_x * grid_y;
  const int threads = tile_x * tile_y;
  const size_t smem = sizeof(float) * kRows * chunk;
  forward_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)tile_start, (const int*)tile_count, (const float*)attr, L,
      width, height, grid_x, tile_x, tile_y, chunk, (const float*)bg,
      (float*)color, (float*)depth, (float*)final_t, (int*)n_contrib);
  return (int)cudaGetLastError();
}
