// K5, the SSIM term of the training loss and its gradient: the mean of the
// windowed SSIM map of img1 and img2 ([C, H, W] float32, the reference's
// 11x11 Gaussian window of sigma 1.5 with zero padding,
// utils/loss_utils.py:38-68), and d mean / d img1.
//
// Replaces no pl.pallas_call: the JAX package's SSIM is plain XLA ops
// (saro_gs_tpu/train/losses.py:67-86), which XLA fuses.  Written out as
// eager PyTorch (ops/ssim.py:parts), one view's loss and its backward are
// some 550 launches of trivial arithmetic, and the host's enqueue of them,
// not the card, sets the loss's time.  This file does the same arithmetic
// in three launches a view, after the public fused-SSIM kernels (Mallick
// et al., "Taming 3DGS", 2024), in this repository's order of operations:
//
//  1. ssim_fwd_kernel, one block per 32x16 output tile of one channel: img1
//     and img2 over the tile and a 5-pixel halo into shared memory (zeros
//     outside the image: the blur's zero padding); x, y, x^2, y^2 and xy
//     blurred by the vertical pass, then the horizontal one, taps 0..10 in
//     order from 0 + t0 * v, as ops/ssim.py:blur sums them; the map in
//     ops/ssim.py:parts' expression and order.  Each block writes the sum
//     of its map values (in double, in a fixed order); where the gradient
//     is wanted, also the six per-pixel terms the backward starts from
//     (mu1, mu2, num1, num2, den1, den2).
//  2. ssim_mean_kernel, one block: the partial sums in a fixed order, over
//     C * H * W.
//  3. ssim_bwd_kernel, the same grid: from G, the cotangent of one map
//     value (the mean's over N, divided by the wrapper as autograd's
//     MeanBackward divides it), the map's gradients by mu1, E[x^2] and
//     E[xy] over the tile and halo, each blurred by the transposed passes
//     (horizontal, then vertical), and d img1 from the three.
// Both directions are autograd's arithmetic through ops/ssim.py:parts,
// operation for operation and in the order its engine runs and accumulates
// them (the backward's comments give that order): built with -fmad=false,
// so every multiply and add rounds on its own, as PyTorch's eager kernels
// do, the terms and d img1 are the eager path's to the bit, and a train
// step is.  Only the mean is summed in another order.  No float atomics:
// two launches agree to the bit.
//
// Bound on H100, from what the function needs: the forward reads img1 and
// img2 (8 bytes a pixel) and does some 240 operations a pixel; the
// backward reads both images and writes d img1 (12 bytes a pixel) and
// does some 154.  At 3x400x400 that is 1.7 us each way (the forward's by
// its arithmetic at 67 TFLOP/s, the backward's by its bytes at 3.35 TB/s).
// What the design costs beyond that: the six terms, written by the forward
// and read back by the backward (24 bytes a pixel each way; 4.6 and 5.2 us
// at 3x400x400 with the images), and each block's halo, read again (42x26
// of 32x16 pixels, 2.1x), from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 11;
constexpr int kR = kTaps / 2;             // halo
constexpr int kTW = 32;                   // output tile width
constexpr int kTH = 16;                   // output tile height
constexpr int kSW = kTW + 2 * kR;         // staged width
constexpr int kSH = kTH + 2 * kR;         // staged height
constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kThreads = kBX * kBY;
constexpr int kRowsPerThread = kTH / kBY;
constexpr int kMeanThreads = 256;

struct Window {
  float t[kTaps];
};

// img [h, w] over the block's tile and halo into dst, zeros outside
__device__ __forceinline__ void stage(float (*dst)[kSW], const float* img,
                                      int h, int w, int oy, int ox, int tid) {
  for (int i = tid; i < kSH * kSW; i += kThreads) {
    const int r = i / kSW, q = i % kSW;
    const int gy = oy + r - kR, gx = ox + q - kR;
    dst[r][q] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                    ? img[(size_t)gy * w + gx] : 0.0f;
  }
}

// the forward's horizontal pass at output column q of row r: taps 0..10
// from 0 + t0 * v, as a Python sum
__device__ __forceinline__ float hpass(float (*src)[kSW], int r, int q,
                                       const Window& win) {
  float acc = 0.0f;
  for (int k = 0; k < kTaps; ++k) acc = acc + win.t[k] * src[r][q + k];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const float* __restrict__ img1,
                const float* __restrict__ img2, int h, int w, Window win,
                float c1, float c2, double* __restrict__ partial,
                float* __restrict__ terms) {
  __shared__ float sx[kSH][kSW];
  __shared__ float sy[kSH][kSW];
  // vertical passes of x, y, x^2, y^2, xy
  __shared__ float sv[5][kTH][kSW];
  __shared__ double warp_sum[kThreads / 32];

  const int tid = threadIdx.y * kBX + threadIdx.x;
  const int ox = blockIdx.x * kTW, oy = blockIdx.y * kTH;
  const size_t n = (size_t)gridDim.z * h * w;
  const size_t plane = (size_t)blockIdx.z * h * w;
  stage(sx, img1 + plane, h, w, oy, ox, tid);
  stage(sy, img2 + plane, h, w, oy, ox, tid);
  __syncthreads();

  for (int i = tid; i < kTH * kSW; i += kThreads) {
    const int r = i / kSW, q = i % kSW;
    float m1 = 0.0f, m2 = 0.0f, e11 = 0.0f, e22 = 0.0f, e12 = 0.0f;
    for (int k = 0; k < kTaps; ++k) {
      const float t = win.t[k];
      const float x = sx[r + k][q], y = sy[r + k][q];
      m1 = m1 + t * x;
      m2 = m2 + t * y;
      e11 = e11 + t * (x * x);
      e22 = e22 + t * (y * y);
      e12 = e12 + t * (x * y);
    }
    sv[0][r][q] = m1;
    sv[1][r][q] = m2;
    sv[2][r][q] = e11;
    sv[3][r][q] = e22;
    sv[4][r][q] = e12;
  }
  __syncthreads();

  double acc = 0.0;
  const int gx = ox + threadIdx.x;
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = threadIdx.y + j * kBY;
    const int gy = oy + r;
    if (gy >= h || gx >= w) continue;
    const int q = threadIdx.x;
    const float mu1 = hpass(sv[0], r, q, win);
    const float mu2 = hpass(sv[1], r, q, win);
    const float e11 = hpass(sv[2], r, q, win);
    const float e22 = hpass(sv[3], r, q, win);
    const float e12 = hpass(sv[4], r, q, win);
    // ops/ssim.py:parts
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
    const float s1 = e11 - mu1_sq;
    const float s2 = e22 - mu2_sq;
    const float s12 = e12 - mu12;
    const float num1 = 2.0f * mu12 + c1;
    const float num2 = 2.0f * s12 + c2;
    const float den1 = mu1_sq + mu2_sq + c1;
    const float den2 = s1 + s2 + c2;
    const float map = (num1 * num2) / (den1 * den2);
    acc += (double)map;
    const size_t at = plane + (size_t)gy * w + gx;
    if (terms != nullptr) {
      terms[at] = mu1;
      terms[n + at] = mu2;
      terms[2 * n + at] = num1;
      terms[3 * n + at] = num2;
      terms[4 * n + at] = den1;
      terms[5 * n + at] = den2;
    }
  }
  // the block's sum: lanes by a fixed tree, then the warps in order
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int k = 0; k < kThreads / 32; ++k) s += warp_sum[k];
    partial[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        s;
  }
}

__global__ void __launch_bounds__(kMeanThreads)
ssim_mean_kernel(const double* __restrict__ partial, int n_partial,
                 double count, float* __restrict__ mean) {
  __shared__ double buf[kMeanThreads];
  double s = 0.0;
  for (int i = threadIdx.x; i < n_partial; i += kMeanThreads) s += partial[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int half = kMeanThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) mean[0] = (float)(buf[0] / count);
}

__global__ void __launch_bounds__(kThreads)
ssim_bwd_kernel(const float* __restrict__ img1,
                const float* __restrict__ img2, int h, int w, Window win,
                const float* __restrict__ terms,
                const float* __restrict__ g_map,
                float* __restrict__ d_img1) {
  // the map's gradients by mu1, E[x^2], E[xy] over the tile and halo
  __shared__ float sg[3][kSH][kSW];
  // their transposed horizontal passes, every staged row
  __shared__ float sh[3][kSH][kTW];

  const int tid = threadIdx.y * kBX + threadIdx.x;
  const int ox = blockIdx.x * kTW, oy = blockIdx.y * kTH;
  const size_t n = (size_t)gridDim.z * h * w;
  const size_t plane = (size_t)blockIdx.z * h * w;
  const float G = g_map[0];

  for (int i = tid; i < kSH * kSW; i += kThreads) {
    const int r = i / kSW, q = i % kSW;
    const int gy = oy + r - kR, gx = ox + q - kR;
    float g_mu1 = 0.0f, g_e11 = 0.0f, g_e12 = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const size_t at = plane + (size_t)gy * w + gx;
      const float mu1 = terms[at], mu2 = terms[n + at];
      const float num1 = terms[2 * n + at], num2 = terms[3 * n + at];
      const float den1 = terms[4 * n + at], den2 = terms[5 * n + at];
      // DivBackward, MulBackward and the Add/SubBackward of parts; mu1's
      // three parts in the order the engine adds them
      const float a = num1 * num2, b = den1 * den2;
      const float g_a = G / b;
      const float g_b = (-G) * ((a / b) / b);
      const float g_num1 = g_a * num2, g_num2 = g_a * num1;
      const float g_den1 = g_b * den2, g_den2 = g_b * den1;
      const float g_s12 = g_num2 * 2.0f;
      const float g_mu12 = g_num1 * 2.0f + (-g_s12);
      const float g_mu1_sq = g_den1 + (-g_den2);
      const float c_sq = g_mu1_sq * mu1;
      g_mu1 = (g_mu12 * mu2 + c_sq) + c_sq;
      g_e11 = g_den2;
      g_e12 = g_s12;
    }
    sg[0][r][q] = g_mu1;
    sg[1][r][q] = g_e11;
    sg[2][r][q] = g_e12;
  }
  __syncthreads();

  // the transposed passes, as autograd runs the blur's backward: the
  // horizontal pass's first, each the products of taps t[10 - k] for
  // k = 0..10 summed in that order, the first product taken as it is
  for (int i = tid; i < kSH * kTW; i += kThreads) {
    const int r = i / kTW, q = i % kTW;
    for (int m = 0; m < 3; ++m) {
      float acc = win.t[kTaps - 1] * sg[m][r][q];
      for (int k = 1; k < kTaps; ++k)
        acc = acc + win.t[kTaps - 1 - k] * sg[m][r][q + k];
      sh[m][r][q] = acc;
    }
  }
  __syncthreads();

  const int gx = ox + threadIdx.x;
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = threadIdx.y + j * kBY;
    const int gy = oy + r;
    if (gy >= h || gx >= w) continue;
    const int q = threadIdx.x;
    float bl[3];
    for (int m = 0; m < 3; ++m) {
      float acc = win.t[kTaps - 1] * sh[m][r][q];
      for (int k = 1; k < kTaps; ++k)
        acc = acc + win.t[kTaps - 1 - k] * sh[m][r + k][q];
      bl[m] = acc;
    }
    const size_t at = plane + (size_t)gy * w + gx;
    // d img1 as the engine accumulates it: E[xy]'s, E[x^2]'s twice, mu1's
    const float c_x2 = bl[1] * img1[at];
    d_img1[at] = ((bl[2] * img2[at] + c_x2) + c_x2) + bl[0];
  }
}

dim3 grid_of(int c, int h, int w) {
  return dim3((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, c);
}

Window window_of(const float* taps) {
  Window win;
  for (int k = 0; k < kTaps; ++k) win.t[k] = taps[k];
  return win;
}

}  // namespace

// Partial sums the forward writes for a [c, h, w] image: one a block.
extern "C" int saro_ssim_partials(int c, int h, int w) {
  const dim3 g = grid_of(c, h, w);
  return (int)(g.x * g.y * g.z);
}

// img1, img2 [c, h, w] float32, contiguous; taps: the 11 window taps (host
// memory); partial: saro_ssim_partials doubles of scratch; mean: one
// float32.  terms [6, c, h, w] float32, or null where no gradient is
// wanted.  Returns the first cudaError_t.
extern "C" int saro_ssim_forward(const void* img1, const void* img2, int c,
                                 int h, int w, const float* taps, float c1,
                                 float c2, void* partial, void* mean,
                                 void* terms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g = grid_of(c, h, w);
  ssim_fwd_kernel<<<g, dim3(kBX, kBY), 0, st>>>(
      (const float*)img1, (const float*)img2, h, w, window_of(taps), c1, c2,
      (double*)partial, (float*)terms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssim_mean_kernel<<<1, kMeanThreads, 0, st>>>(
      (const double*)partial, (int)(g.x * g.y * g.z),
      (double)c * (double)h * (double)w, (float*)mean);
  return (int)cudaGetLastError();
}

// d_img1 [c, h, w] float32 from the forward's terms, both images and
// g_map, the cotangent of each map value (one float32 on the card).
extern "C" int saro_ssim_backward(const void* img1, const void* img2, int c,
                                  int h, int w, const float* taps,
                                  const void* terms, const void* g_map,
                                  void* d_img1, void* stream) {
  ssim_bwd_kernel<<<grid_of(c, h, w), dim3(kBX, kBY), 0,
                    (cudaStream_t)stream>>>(
      (const float*)img1, (const float*)img2, h, w, window_of(taps),
      (const float*)terms, (const float*)g_map, (float*)d_img1);
  return (int)cudaGetLastError();
}
