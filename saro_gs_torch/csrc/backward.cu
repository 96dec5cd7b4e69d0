// K3, the backward compositor: per-instance gradients of the per-tile
// alpha compositing (the reference's renderCUDA backward,
// backward.cu:399-557).
//
// Replaces the TPU kernel saro_gs_tpu/ops/tile_kernels.py:_bwd_kernel
// (entered through backward_tiles_pallas).  The TPU version turns the
// replay into [chunk, pixels] matrices with prefix products and sums the
// pixels of an instance with one-hot moment matmuls into shared chunk
// windows, because Mosaic wants dense matrices and has no cheap reduction
// over lanes.  None of that is carried over; what is kept is the
// arithmetic of saro_gs_tpu/ops/compositing.py:backward_tiles.
//
// Design: one block per tile, one thread per pixel.  The block replays its
// tile's range FRONT to back, `chunk` instances at a time from shared
// memory, with the forward's own alpha chain (alpha_chain.cuh), and stops
// at the tile's largest n_contrib: no pixel has a contributor past it.  A
// pixel recovers the colour behind instance k from the forward's outputs,
// S_k = (color - T_final * bg) - sum_{i<=k} w_i c_i, so no reverse walk and
// no division of T by (1 - alpha) is needed.  Each instance lies in exactly
// one tile, so its nine values are summed over the block's pixels (a
// butterfly of warp shuffles, then the warps' partial sums in warp order
// through shared memory) and written once: no atomics, a fixed summation
// order, two launches equal to the bit.  Slots of the range past the replay
// bound are not written; the wrapper hands in a zeroed output.
//
// Rows of the output [9, L]: d_rgb (3), d_mean2d (2, in NDC units: the
// pixel gradient times 0.5 * width, 0.5 * height of the FULL frame),
// d_conic (3, the true b-gradient), d_opacity (1).  As in the reference
// the 0.99 clamp is NOT gated: d_opacity = g * d_alpha even where the
// clamp cut.  Pixels outside the image contribute nothing.
//
// Bound on H100: operations.  A contributing instance-pixel pair costs
// about 70 flops, a warp's reduction 45 shuffles per instance it touches;
// the bytes (10 words per instance in, 9 out, 8 words per pixel in) are
// far fewer.  Warps none of whose pixels an instance touches skip its
// reduction; nothing is done yet about lanes idle past their n_contrib.

#include <cuda_runtime.h>

#include "alpha_chain.cuh"

namespace {

using saro::kRows;
constexpr int kGrad = 9;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(1024)
backward_kernel(const int* __restrict__ tile_start,
                const int* __restrict__ tile_count,
                const float* __restrict__ attr, int L, int width, int height,
                int grid_x, int tile_x, int tile_y, int chunk,
                const float* __restrict__ bg,
                const int* __restrict__ n_contrib,
                const float* __restrict__ out_color,
                const float* __restrict__ final_t,
                const float* __restrict__ d_color, float* __restrict__ grad) {
  extern __shared__ float sh[];          // [kRows][chunk] staged instances
  float* part = sh + kRows * chunk;      // [nwarps][kGrad][chunk] partials
  __shared__ int warp_max[32];

  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lx = threadIdx.x % tile_x;
  const int ly = threadIdx.x / tile_x;
  const int px = (t % grid_x) * tile_x + lx;
  const int py = (t / grid_x) * tile_y + ly;
  const bool inside = px < width && py < height;
  const float pxf = (float)px;
  const float pyf = (float)py;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const size_t hw = (size_t)height * width;
  const size_t pix = (size_t)py * width + px;

  // a pixel outside the image replays nothing (nc = 0)
  int nc = inside ? n_contrib[pix] : 0;
  const int wmax = __reduce_max_sync(kFull, nc);
  if (lane == 0) warp_max[warp] = wmax;
  __syncthreads();
  int limit = 0;
  for (int w = 0; w < nwarps; ++w) limit = max(limit, warp_max[w]);
  limit = min(limit, count);

  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, tf = 0.0f;
  float S0 = 0.0f, S1 = 0.0f, S2 = 0.0f;
  if (inside) {
    d0 = d_color[pix];
    d1 = d_color[hw + pix];
    d2 = d_color[2 * hw + pix];
    tf = final_t[pix];
    // colour of the splats alone; the walk subtracts each contribution
    S0 = out_color[pix] - tf * bg[0];
    S1 = out_color[hw + pix] - tf * bg[1];
    S2 = out_color[2 * hw + pix] - tf * bg[2];
  }
  const float bg_dot = d0 * bg[0] + d1 * bg[1] + d2 * bg[2];
  const float half_w = 0.5f * (float)width;
  const float half_h = 0.5f * (float)height;
  float T = 1.0f;

  for (int b0 = 0; b0 < limit; b0 += chunk) {
    const int nb = min(chunk, limit - b0);
    saro::stage_batch(sh, attr, L, start + b0, nb, chunk);
    for (int i = threadIdx.x; i < nwarps * kGrad * chunk; i += blockDim.x)
      part[i] = 0.0f;
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f, v4 = 0.0f,
            v5 = 0.0f, v6 = 0.0f, v7 = 0.0f, v8 = 0.0f;
      bool contrib = false;
      saro::Splat s;
      if (b0 + j < nc && saro::eval_alpha(sh, chunk, j, pxf, pyf, s)) {
        const float test_t = T * (1.0f - s.alpha);
        if (test_t < saro::kTEps) {
          nc = 0;   // the forward's latch: this pixel's walk ended here
        } else {
          contrib = true;
          const float ca = sh[2 * chunk + j];
          const float cb = sh[3 * chunk + j];
          const float cc = sh[4 * chunk + j];
          const float c0 = sh[6 * chunk + j];
          const float c1 = sh[7 * chunk + j];
          const float c2 = sh[8 * chunk + j];
          const float w = s.alpha * T;
          S0 = S0 - w * c0;
          S1 = S1 - w * c1;
          S2 = S2 - w * c2;
          const float inv = 1.0f / (1.0f - s.alpha);
          const float d_alpha = ((c0 * T - S0 * inv) * d0
                                 + (c1 * T - S1 * inv) * d1
                                 + (c2 * T - S2 * inv) * d2)
                                - tf * inv * bg_dot;
          // the 0.99 clamp is not gated (backward.cu:499,538)
          const float d_g = sh[5 * chunk + j] * d_alpha;
          const float gdx = s.g * s.dx;
          const float gdy = s.g * s.dy;
          v0 = w * d0;
          v1 = w * d1;
          v2 = w * d2;
          v3 = d_g * (-gdx * ca - gdy * cb) * half_w;
          v4 = d_g * (-gdy * cc - gdx * cb) * half_h;
          v5 = d_g * (-0.5f * gdx * s.dx);
          v6 = d_g * (-gdx * s.dy);
          v7 = d_g * (-0.5f * gdy * s.dy);
          v8 = s.g * d_alpha;
          T = test_t;
        }
      }
      // warps that this instance touches nowhere keep their zeros
      if (__ballot_sync(kFull, contrib) != 0u) {
        v0 = warp_sum(v0); v1 = warp_sum(v1); v2 = warp_sum(v2);
        v3 = warp_sum(v3); v4 = warp_sum(v4); v5 = warp_sum(v5);
        v6 = warp_sum(v6); v7 = warp_sum(v7); v8 = warp_sum(v8);
        if (lane == 0) {
          float* p = part + (size_t)warp * kGrad * chunk + j;
          p[0 * chunk] = v0; p[1 * chunk] = v1; p[2 * chunk] = v2;
          p[3 * chunk] = v3; p[4 * chunk] = v4; p[5 * chunk] = v5;
          p[6 * chunk] = v6; p[7 * chunk] = v7; p[8 * chunk] = v8;
        }
      }
    }
    __syncthreads();
    // the warps' partial sums in warp order, one writer per value
    for (int i = threadIdx.x; i < kGrad * chunk; i += blockDim.x) {
      const int r = i / chunk;
      const int j = i - r * chunk;
      if (j < nb) {
        float acc = 0.0f;
        for (int w = 0; w < nwarps; ++w)
          acc = acc + part[(size_t)w * kGrad * chunk + i];
        grad[(size_t)r * L + start + b0 + j] = acc;
      }
    }
    __syncthreads();   // the next batch overwrites shared memory
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  grad [9, L] must
// be zeroed by the caller; tile_x * tile_y must be a multiple of 32.
extern "C" int saro_backward_tiles(const void* tile_start,
                                   const void* tile_count, const void* attr,
                                   int L, int width, int height, int grid_x,
                                   int grid_y, int tile_x, int tile_y,
                                   int chunk, const void* bg,
                                   const void* n_contrib,
                                   const void* out_color, const void* final_t,
                                   const void* d_color, void* grad,
                                   void* stream) {
  const int blocks = grid_x * grid_y;
  const int threads = tile_x * tile_y;
  const int nwarps = threads / 32;
  const size_t smem = sizeof(float) * (kRows + nwarps * kGrad) * chunk;
  cudaError_t err = cudaFuncSetAttribute(
      backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  backward_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)tile_start, (const int*)tile_count, (const float*)attr, L,
      width, height, grid_x, tile_x, tile_y, chunk, (const float*)bg,
      (const int*)n_contrib, (const float*)out_color, (const float*)final_t,
      (const float*)d_color, (float*)grad);
  return (int)cudaGetLastError();
}
