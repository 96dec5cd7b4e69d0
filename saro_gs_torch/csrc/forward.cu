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
// Bound on H100: operations (about 20 flops for every instance-pixel pair
// the plain walk evaluates; the bytes, 10 words per instance and 5 per
// pixel, are far fewer).  What costs time is pairs that can never count
// and the long walks of the densest tiles, which a block a tile puts on
// one SM.  So:
//  * a tile is split into bands of rows, one block of at most 256 threads
//    each (a 32x32 tile is 4 blocks of 32x8 pixels; a 16x16 tile is one
//    block).  A pixel depends on no other pixel, so the bands share
//    nothing: each block stages the tile's batches itself;
//  * a warp owns a compact 8x4-pixel patch and skips every instance that
//    cannot reach any of its pixels still walking (alpha_chain.cuh's warp
//    cull, the one the backward replay uses; conservative, so no pixel's
//    decisions change).  The cull's per-instance terms (reach_terms) are
//    computed once per block as a batch lands; the lanes then test 32
//    instances at once against the warp's box, and the warp walks the set
//    bits of the ballot in order, so each pixel meets its contributors in
//    the plain order;
//  * the warp evaluates the alpha of two kept instances at once (they do
//    not depend on each other) and applies them in order (one, four or
//    eight at once measured no faster; PERF.md section 6);
//  * a batch is instance-major in shared memory (16 floats an instance),
//    so a pixel reads an instance with float4 loads that the warp's lanes
//    share (the table's attribute-major layout, ten 4-byte loads, measured
//    slower);
//  * a warp whose pixels have all ended (or lie outside the image) skips
//    the rest of the walk; the block leaves once all its warps have;
//  * batches of `chunk` instances are staged with cp.async into a second
//    buffer while the current one is walked;
//  * the bands of the heaviest tiles launch first (tiles by tile_count, a
//    stable descending order that binning computes once per view for K1
//    and K3), so the longest blocks start in the first wave (raster order
//    measured slower).  No pixel's arithmetic depends on the order or on
//    the batch size.
// What holds it still: the walk's instructions, some 60 for each (warp,
// kept instance) pair (expf's among them), and every band staging its
// tile's whole range and computing the cull's terms for it.
// scripts/torch_kernel_probe.py times the frame, its heaviest tiles and
// the rest, and counts the pairs the cull keeps (--counters).
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
//  * colour = C + T * bg; n_contrib = 1-based rank of the last contributor
//    in the tile's range.
// Pixel coordinates are the integer pixel indices (no +0.5).
//
// Strip mode (tile-axis sharding, saro_gs_tpu/ops/tile_kernels.py:670):
// the tiles are a strip's, strip-local, whose first pixel row is y0_px;
// pixel coordinates, and so the warp boxes of the cull, are full-frame,
// the inside test is against the full frame's height, and the outputs are
// the strip's `rows` rows (past the frame's bottom: background, T = 1,
// depth 15, n_contrib 0).  A whole frame is y0_px = 0, rows = height.

#include <climits>

#include <cuda_runtime.h>

#include "alpha_chain.cuh"

namespace {

using saro::kRows;
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIlp = 2;   // kept instances a warp evaluates at once
// Floats a staged instance takes in shared memory: the table's kRows rows
// (x, y, ca, cb | cc, op, r, g | b, depth), then the cull's terms (lam,
// mag | thr, hx, hy) and one unused float, so float4 loads line up.
constexpr int kStageRows = 16;

// Stage a batch instance-major: [chunk][kStageRows].
__device__ __forceinline__ void stage(float* sh, const float* __restrict__ attr,
                                      int L, int first, int nb, int chunk) {
  saro::stage_rows_async(sh, attr, L, first, nb, chunk, 1, kStageRows);
}

__global__ void __launch_bounds__(kMaxThreads)
forward_kernel(const int* __restrict__ order,
               const int* __restrict__ tile_start,
               const int* __restrict__ tile_count,
               const float* __restrict__ attr, int L, int width, int height,
               int grid_x, int tile_x, int tile_y, int y0_px, int rows,
               int band_rows, int bands, int chunk,
               const float* __restrict__ bg,
               float* __restrict__ color, float* __restrict__ depth_out,
               float* __restrict__ final_t, int* __restrict__ n_contrib) {
  extern __shared__ float4 smem4[];   // two [chunk][kStageRows] buffers
  float* smem = reinterpret_cast<float*>(smem4);

  const int t = order[blockIdx.x / bands];
  const int band = blockIdx.x % bands;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this block's band of rows, and the thread's pixel in it: warps take
  // 8x4 patches where the band allows, else consecutive pixels
  const int y0 = band * band_rows;
  const int bw = tile_x;
  const int bh = min(band_rows, tile_y - y0);
  int lx, ly;
  bool p_ok;
  if (bw % 8 == 0 && bh % 4 == 0) {
    const int pw = bw / 8;
    lx = (warp % pw) * 8 + (lane & 7);
    ly = (warp / pw) * 4 + (lane >> 3);
    p_ok = warp < pw * (bh / 4);
  } else {
    lx = tid % bw;
    ly = tid / bw;
    p_ok = tid < bw * bh;
  }
  const int px = (t % grid_x) * tile_x + lx;
  const int ly_buf = (t / grid_x) * tile_y + y0 + ly;   // row in the buffer
  const int py = ly_buf + y0_px;
  const bool stored = p_ok && px < width && ly_buf < rows;
  const bool inside = stored && py < height;
  const float pxf = (float)px;
  const float pyf = (float)py;
  const int start = tile_start[t];
  const int count = tile_count[t];

  float T = 1.0f;
  float C0 = 0.0f, C1 = 0.0f, C2 = 0.0f;
  float D = 15.0f;
  int nc = 0;
  bool done = !inside;

  if (count > 0)
    stage(smem, attr, L, start, min(chunk, count), chunk);
  int cur = 0;
  for (int b0 = 0; b0 < count; b0 += chunk) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    // this batch is staged, every warp is done with the last one (whose
    // buffer the next copy fills), and the block leaves once no pixel is
    // still walking
    if (__syncthreads_count(done) == (int)blockDim.x) break;
    const int nb = min(chunk, count - b0);
    float* sh = smem + cur * kStageRows * chunk;
    const float4* sh4 = reinterpret_cast<const float4*>(sh);
    // the cull's per-instance terms, once per block
    for (int i = tid; i < nb; i += blockDim.x) {
      const float4 a = sh4[4 * i];
      const float4 b = sh4[4 * i + 1];
      const saro::Reach r = saro::reach_terms(a.z, a.w, b.x, b.y);
      float* terms = sh + kStageRows * i + kRows;
      terms[0] = r.lam;
      terms[1] = r.mag;
      terms[2] = r.thr;
      terms[3] = r.hx;
      terms[4] = r.hy;
    }
    // the next batch into the other buffer, which every warp has left
    cur ^= 1;
    if (b0 + chunk < count)
      stage(smem + cur * kStageRows * chunk, attr, L, start + b0 + chunk,
            min(chunk, count - b0 - chunk), chunk);
    __syncthreads();   // the terms are in place
    if (__all_sync(kFull, done)) continue;
    // the box of the warp's pixels still walking, for the cull
    const float wx0 = (float)__reduce_min_sync(kFull, done ? INT_MAX : px);
    const float wx1 = (float)__reduce_max_sync(kFull, done ? INT_MIN : px);
    const float wy0 = (float)__reduce_min_sync(kFull, done ? INT_MAX : py);
    const float wy1 = (float)__reduce_max_sync(kFull, done ? INT_MIN : py);
    const float diag2 =
        (wx1 - wx0) * (wx1 - wx0) + (wy1 - wy0) * (wy1 - wy0);
    bool warp_done = false;
    for (int g = 0; g < nb && !warp_done; g += 32) {
      const int jl = g + lane;
      bool reach = false;
      if (jl < nb) {
        const float4 q0 = sh4[4 * jl];
        const float4 q2 = sh4[4 * jl + 2];
        const float4 q3 = sh4[4 * jl + 3];
        reach = saro::reaches_box(q0.x, q0.y,
                                  saro::Reach{q2.z, q2.w, q3.x, q3.y, q3.z},
                                  wx0, wx1, wy0, wy1, diag2);
      }
      for (unsigned live = __ballot_sync(kFull, reach); live != 0u;) {
        // the next kIlp kept instances (slot -1 past the last): their alpha
        // evaluations do not depend on each other, so they overlap
        int js[kIlp];
        bool ev[kIlp];
        float al[kIlp], cr[kIlp], cg[kIlp];
#pragma unroll
        for (int k = 0; k < kIlp; ++k) {
          js[k] = live != 0u ? g + __ffs(live) - 1 : -1;
          live &= live - 1u;
          const int jj = js[k] < 0 ? g : js[k];
          const float4 p0 = sh4[4 * jj];
          const float4 p1 = sh4[4 * jj + 1];
          // broken-conic guard (power > 0 skips) and the 1/255 cutoff; a
          // NaN fails both comparisons and is skipped too
          saro::Splat s;
          ev[k] = saro::eval_alpha(p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, pxf,
                                   pyf, s) && js[k] >= 0;
          al[k] = s.alpha;
          cr[k] = p1.z;
          cg[k] = p1.w;
        }
        // applied in order, by select: the instance that would take T
        // below 1e-4 does not contribute and ends the pixel's walk (the
        // termination latch); the median depth is taken where T crosses 0.5
#pragma unroll
        for (int k = 0; k < kIlp; ++k) {
          const int j = js[k] < 0 ? g : js[k];
          const float4 p2 = sh4[4 * j + 2];   // b, depth
          const bool ok = ev[k] && !done;
          const float test_t = T * (1.0f - al[k]);
          const bool con = ok && !(test_t < saro::kTEps);
          done = done || (ok && test_t < saro::kTEps);
          const float w = al[k] * T;
          C0 = con ? C0 + w * cr[k] : C0;
          C1 = con ? C1 + w * cg[k] : C1;
          C2 = con ? C2 + w * p2.x : C2;
          D = (con && T > 0.5f && test_t < 0.5f) ? p2.y : D;
          nc = con ? b0 + j + 1 : nc;
          T = con ? test_t : T;
        }
        if (__all_sync(kFull, done)) {
          warp_done = true;
          break;
        }
      }
    }
  }
  // no block leaves with a copy into its shared memory in flight
  asm volatile("cp.async.wait_group 0;\n" ::);

  if (stored) {
    const size_t hw = (size_t)rows * width;
    const size_t pix = (size_t)ly_buf * width + px;
    color[pix] = C0 + T * bg[0];
    color[hw + pix] = C1 + T * bg[1];
    color[2 * hw + pix] = C2 + T * bg[2];
    depth_out[pix] = D;
    final_t[pix] = T;
    if (n_contrib != nullptr) n_contrib[pix] = nc;
  }
}

}  // namespace

// Rows of a band of a tile_x x tile_y tile: as many as a block of
// kMaxThreads holds, a multiple of 4 where that is at least 4, so warps
// take 8x4 patches (32x32 tiles: 8 rows, 4 bands; 16x16: 16 rows, one
// band); 0 where a row of the tile does not fit a block.
extern "C" int saro_forward_band_rows(int tile_x, int tile_y) {
  if (tile_x < 1 || tile_y < 1 || tile_x > kMaxThreads) return 0;
  const int rows = kMaxThreads / tile_x < tile_y ? kMaxThreads / tile_x
                                                 : tile_y;
  return rows >= 4 ? rows - rows % 4 : rows;
}

// Returns the cudaError_t of the launch (0 = success).  order [n_tiles] is
// a permutation of the tiles (the launch order); n_contrib may be null
// (need_aux=False); the outputs have `rows` rows, the first at global
// pixel row y0_px (a whole frame: 0 and height).  A tile is
// ceil(tile_y / band_rows) blocks of roundup32(tile_x * band_rows)
// threads, one band of rows each (saro_forward_band_rows).
extern "C" int saro_forward_tiles(const void* order, const void* tile_start,
                                  const void* tile_count, const void* attr,
                                  int L, int width, int height, int grid_x,
                                  int grid_y, int tile_x, int tile_y,
                                  int y0_px, int rows, int chunk,
                                  const void* bg, void* color,
                                  void* depth, void* final_t,
                                  void* n_contrib, void* stream) {
  const int band_rows = saro_forward_band_rows(tile_x, tile_y);
  if (band_rows == 0 || chunk < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = grid_x * grid_y;
  if (n_tiles == 0) return (int)cudaSuccess;
  const int bands = (tile_y + band_rows - 1) / band_rows;
  const int threads = (tile_x * band_rows + 31) / 32 * 32;
  const size_t smem = sizeof(float) * 2 * kStageRows * (size_t)chunk;
  cudaError_t err = cudaFuncSetAttribute(
      forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  forward_kernel<<<n_tiles * bands, threads, smem, (cudaStream_t)stream>>>(
      (const int*)order, (const int*)tile_start, (const int*)tile_count,
      (const float*)attr, L, width, height, grid_x, tile_x, tile_y, y0_px,
      rows, band_rows, bands, chunk, (const float*)bg, (float*)color,
      (float*)depth, (float*)final_t, (int*)n_contrib);
  return (int)cudaGetLastError();
}
