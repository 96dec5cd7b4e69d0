// The alpha chain shared by the forward compositor (forward.cu) and its
// backward replay (backward.cu): how a block stages a batch of the staged
// instance table in shared memory (each kernel in its own layout), how a
// warp culls the staged instances
// that cannot reach its pixels, and how one pixel evaluates one staged
// instance.  Both kernels include this file, so the replay makes the
// forward's contribute/skip decisions bit for bit (both are built with
// -fmad=false; expf is the accurate one) and culls what the forward culls.
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

// Copy instances [first, first + nb) of the [kRows, L] table into shared
// memory with cp.async, row r of batch slot j to sh[r * row_stride +
// j * slot_stride] for j < chunk: issued by every thread of the block and
// committed as one group, so the caller can walk the batch before it while
// this one is in flight (cp.async.wait_group, then __syncthreads).
// Masking is by select, never by multiply: slots past nb (a partial last
// batch) are zero-filled by the copy itself (source size 0), never read
// from the table (0 * NaN is NaN).
__device__ __forceinline__ void stage_rows_async(
    float* sh, const float* __restrict__ attr, int L, int first, int nb,
    int chunk, int row_stride, int slot_stride) {
  for (int i = threadIdx.x; i < kRows * chunk; i += blockDim.x) {
    const int r = i / chunk;
    const int j = i - r * chunk;
    const bool in = j < nb;
    const float* src = in ? attr + (size_t)r * L + first + j : attr;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(
        sh + r * row_stride + j * slot_stride);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 4 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The batch as a [kRows][chunk] buffer (the backward's layout).
__device__ __forceinline__ void stage_batch_async(
    float* sh, const float* __restrict__ attr, int L, int first, int nb,
    int chunk) {
  stage_rows_async(sh, attr, L, first, nb, chunk, chunk, 1);
}

struct Splat {
  float dx, dy;  // splat centre minus pixel
  float g;       // expf(min(power, 0))
  float alpha;   // min(0.99, opacity * g)
};

// Evaluate the instance with centre (x, y), conic (ca, cb, cc) and
// opacity op at pixel (pxf, pyf); true where it counts.
__device__ __forceinline__ bool eval_alpha(float x, float y, float ca,
                                           float cb, float cc, float op,
                                           float pxf, float pyf, Splat& s) {
  s.dx = x - pxf;
  s.dy = y - pyf;
  const float power =
      -0.5f * (ca * s.dx * s.dx + cc * s.dy * s.dy) - cb * s.dx * s.dy;
  s.g = expf(fminf(power, 0.0f));
  s.alpha = fminf(op * s.g, kAlphaMax);
  return power <= 0.0f && s.alpha >= kAlphaMin;
}

// Evaluate staged instance j of a [kRows][chunk] batch at pixel (pxf, pyf).
__device__ __forceinline__ bool eval_alpha(const float* sh, int chunk, int j,
                                           float pxf, float pyf, Splat& s) {
  return eval_alpha(sh[j], sh[chunk + j], sh[2 * chunk + j],
                    sh[3 * chunk + j], sh[4 * chunk + j], sh[5 * chunk + j],
                    pxf, pyf, s);
}

// The warp cull.  reaches_box(...) is false only where every pixel of the
// box [wx0, wx1] x [wy0, wy1] (diag2 its squared diagonal) would refuse
// the instance in eval_alpha: alpha < 1/255 when 0.5 * lambda_min * d^2
// (d the distance from the splat's mean to the box, a lower bound of
// -power) clears ln(opacity * 255) by a margin that covers power's
// rounding at the farthest pixel ((d + diag)^2 <= 2 d^2 + 2 diag^2),
// expf's and logf's, and this sum's own; or the box lies outside the box
// of the ellipse where alpha can reach 1/255.  So a cull by this test
// changes no bit of what the walk computes.  No NaN is culled: a
// comparison with NaN is false, and fmaxf drops a NaN lambda to 0, which
// leaves only the opacity test.  Plain restatement, in this order of
// operations: ops/compositing.py:warp_may_reach.
//
// The terms that do not depend on the box, per instance:
struct Reach {
  float lam;      // lambda_min less its rounding; 0 for an indefinite conic
  float mag;      // |a| + |c| + 2 |b|: the weight of power's rounding
  float thr;      // ln(opacity * 255)
  float hx, hy;   // half-widths of the ellipse's box; +inf where none
};

__device__ __forceinline__ Reach reach_terms(float ca, float cb, float cc,
                                             float op) {
  Reach r;
  r.mag = fabsf(ca) + fabsf(cc) + 2.0f * fabsf(cb);
  const float dd = ca - cc;
  r.lam = fmaxf(
      0.5f * (ca + cc) - sqrtf(0.25f * (dd * dd) + cb * cb) - 1e-6f * r.mag,
      0.0f);
  r.thr = logf(op / kAlphaMin);
  // the ellipse's bounding box: a pixel that passes has computed power >=
  // -(thr + 1e-3), and power's rounding is at most eps of |power| (eps =
  // 2e-6 * mag / lambda), so q^T A q <= 2 (thr + 1e-3) / (1 - eps); its box
  // is |q_x| <= sqrt(that * cc / det), |q_y| <= sqrt(that * ca / det), det
  // taken below its rounding
  r.hx = r.hy = __int_as_float(0x7f800000);   // +inf
  const float eps = 2e-6f * r.mag / r.lam;
  if (r.lam > 0.0f && eps < 0.5f && r.thr > 0.0f) {
    const float t2 = 2.0f * (r.thr + 1e-3f) / (1.0f - eps) * 1.00001f;
    const float det = ca * cc - cb * cb - 4e-7f * (fabsf(ca * cc) + cb * cb);
    if (det > 0.0f) {
      r.hx = sqrtf(t2 * cc / det) * 1.00001f + 1e-3f;
      r.hy = sqrtf(t2 * ca / det) * 1.00001f + 1e-3f;
    }
  }
  return r;
}

__device__ __forceinline__ bool reaches_box(float mx, float my,
                                            const Reach& r, float wx0,
                                            float wx1, float wy0, float wy1,
                                            float diag2) {
  const float ddx = fmaxf(fmaxf(wx0 - mx, mx - wx1), 0.0f);
  const float ddy = fmaxf(fmaxf(wy0 - my, my - wy1), 0.0f);
  const float dist2 = ddx * ddx + ddy * ddy;
  const float a = 0.5f * r.lam * dist2;
  const float m = 1e-6f * r.mag * (2.0f * dist2 + 2.0f * diag2);
  const bool far = a - m - 1e-3f - 1e-5f * (a + m) > r.thr;
  return !(far || ddx > r.hx || ddy > r.hy);
}

// Whether staged instance j may count at some pixel of the box.
__device__ __forceinline__ bool warp_may_reach(const float* sh, int chunk,
                                               int j, float wx0, float wx1,
                                               float wy0, float wy1,
                                               float diag2) {
  const Reach r = reach_terms(sh[2 * chunk + j], sh[3 * chunk + j],
                              sh[4 * chunk + j], sh[5 * chunk + j]);
  return reaches_box(sh[j], sh[chunk + j], r, wx0, wx1, wy0, wy1, diag2);
}

}  // namespace saro
