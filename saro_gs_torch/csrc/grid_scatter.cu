// K4, the field-gradient scatter: deterministic scatter-add of weighted
// bilinear-tap cotangents into the flattened mip pyramid of one plane,
//   out[c, cell] = sum over taps k with cells[k] == cell of
//                  weights[k] * dfeat[point[k], c].
//
// Replaces the TPU kernel saro_gs_tpu/ops/grid_scatter.py:_scatter_kernel
// (entered through scatter_taps_pallas).  The TPU version answers a serial
// scatter unit: it sorts the tap rows by base cell, gives 512 cells to a
// grid step, copies chunk-aligned envelopes of the sorted table and
// accumulates with a weighted one-hot matmul.  On Hopper only the sort is
// kept (it runs in the wrapper, as the JAX wrapper sorts outside its
// kernel): the taps arrive sorted by cell, stably, with `seg` the bounds
// of each cell's segment, and one warp owns one output cell.  It walks the
// segment in sorted order with lane = channel, so every tap is one
// coalesced read of a dfeat row and the sum stays in a register: no
// atomics, a fixed order (tap-major, then point order, the order of the
// plain per-tap index_add_ on a CPU), two launches equal to the bit.  A
// cell with no taps is written zero.  A hot cell (every point on one
// texel) is one warp's long sequential walk: slow, still exact.
//
// Bound on H100: bytes.  Per tap 8 bytes of (point, weight) and a C-float
// row of dfeat, per cell C floats out and two segment bounds; one multiply
// and one add per tap and channel.  At the shapes of this model (a few
// hundred thousand taps, tens of thousands of cells) the launch is mostly
// latency: segments are short and the card is not filled.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ seg, const int* __restrict__ point,
               const float* __restrict__ weight,
               const float* __restrict__ dfeat, int c_feat, int total,
               float* __restrict__ out) {
  const int cell = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (cell >= total) return;
  const int s = seg[cell];
  const int e = seg[cell + 1];
  for (int c = lane; c < c_feat; c += 32) {
    float acc = 0.0f;
    for (int k = s; k < e; ++k)
      acc = acc + weight[k] * dfeat[(size_t)point[k] * c_feat + c];
    out[(size_t)c * total + cell] = acc;
  }
}

}  // namespace

// seg [total + 1], point/weight [n_sorted], dfeat [N, c_feat] row-major,
// out [c_feat, total].  Returns the cudaError_t of the launch.
extern "C" int saro_scatter_taps(const void* seg, const void* point,
                                 const void* weight, const void* dfeat,
                                 int c_feat, int total, void* out,
                                 void* stream) {
  const int warps_per_block = kThreads / 32;
  const int blocks = (total + warps_per_block - 1) / warps_per_block;
  scatter_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)seg, (const int*)point, (const float*)weight,
      (const float*)dfeat, c_feat, total, (float*)out);
  return (int)cudaGetLastError();
}
