// The alpha chain shared by the forward compositor (forward.cu) and its
// backward replay (backward.cu): how a block stages a batch of the staged
// instance table in shared memory, and how one pixel evaluates one staged
// instance.  Both kernels include this file, so the replay makes the
// forward's contribute/skip decisions bit for bit (both are built with
// -fmad=false; expf is the accurate one).
//
//  * alpha = min(0.99, opacity * expf(min(power, 0)));
//  * an instance counts only where power <= 0 (the broken-conic guard,
//    the reference's forward.cu:310) and alpha >= 1/255; a NaN fails both
//    comparisons and is skipped;
//  * the instance that would take T below 1e-4 does not contribute and
//    ends the pixel's walk (the callers test T * (1 - alpha) < kTEps).
// Pixel coordinates are the integer pixel indices (no +0.5).
#pragma once

#include <cuda_runtime.h>

namespace saro {

constexpr int kRows = 10;  // x, y, conic a/b/c, opacity, r, g, b, depth
constexpr float kAlphaMax = (float)0.99;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kTEps = (float)1e-4;

// Copy instances [first, first + nb) of the [kRows, L] table into the
// block's shared [kRows][chunk] buffer.  Masking is by select, never by
// multiply: slots past nb (a partial last batch) are filled with 0 and
// never read; reading them would be garbage, and 0 * NaN is NaN.
__device__ __forceinline__ void stage_batch(float* sh,
                                            const float* __restrict__ attr,
                                            int L, int first, int nb,
                                            int chunk) {
  for (int i = threadIdx.x; i < kRows * chunk; i += blockDim.x) {
    const int r = i / chunk;
    const int j = i - r * chunk;
    sh[i] = j < nb ? attr[(size_t)r * L + first + j] : 0.0f;
  }
}

struct Splat {
  float dx, dy;  // splat centre minus pixel
  float g;       // expf(min(power, 0))
  float alpha;   // min(0.99, opacity * g)
};

// Evaluate staged instance j at pixel (pxf, pyf); true where it counts.
__device__ __forceinline__ bool eval_alpha(const float* sh, int chunk, int j,
                                           float pxf, float pyf, Splat& s) {
  s.dx = sh[0 * chunk + j] - pxf;
  s.dy = sh[1 * chunk + j] - pyf;
  const float ca = sh[2 * chunk + j];
  const float cb = sh[3 * chunk + j];
  const float cc = sh[4 * chunk + j];
  const float power =
      -0.5f * (ca * s.dx * s.dx + cc * s.dy * s.dy) - cb * s.dx * s.dy;
  s.g = expf(fminf(power, 0.0f));
  s.alpha = fminf(sh[5 * chunk + j] * s.g, kAlphaMax);
  return power <= 0.0f && s.alpha >= kAlphaMin;
}

}  // namespace saro
