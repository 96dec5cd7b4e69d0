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
// Semantics: every pixel replays its tile's range FRONT to back with the
// forward's own alpha chain (alpha_chain.cuh: eval_alpha, the staging's
// select-not-multiply masking), up to the tile's largest n_contrib, and its
// walk ends at the forward's latch T * (1 - alpha) < 1e-4.  A pixel
// recovers the colour behind instance k from the forward's outputs,
// S_k = (color - T_final * bg) - sum_{i<=k} w_i c_i, so no reverse walk and
// no division of T by (1 - alpha).  Each instance lies in exactly one tile,
// so its nine values are summed over the tile's pixels in a fixed order and
// written once: no atomics, two launches equal to the bit.  Slots past the
// replay bound are not written; the wrapper hands in a zeroed output.
//
// Bound on H100: operations (20 flops for every replayed instance-pixel
// pair, about 58 more for the quarter of them that contribute).  The first
// design (one 1024-thread block per tile, one pixel a thread, nine
// butterflies of 45 shuffles for every instance a warp touched) was held
// by its heaviest tiles: a tile's replay is one block's serial walk on one
// SM, and on an H100 the arena frame's heaviest tile alone took 1.03 ms of
// the frame's 1.82 (scripts/torch_kernel_probe.py).  This design:
//  * a tile is a thread-block cluster, one block per band of rows (a
//    32x32 tile is 4 blocks of 32x8 pixels, 256 threads), on 4 SMs;
//    after each batch the bands' per-instance sums are added in band order
//    through distributed shared memory, so a heavy tile's walk is spread
//    over the cluster's SMs with no scratch in device memory;
//  * a warp owns a compact 8x4-pixel patch and skips every instance that
//    cannot reach any pixel of it (alpha_chain.cuh:warp_may_reach, shared
//    with the forward: by lambda_min and by the ellipse's box, with margins
//    for the rounding, so the cull changes no bit of the output).  The
//    lanes test 32 instances at once and the warp walks only the set bits
//    of the ballot;
//  * a warp replays the instances it keeps two at a time (their alpha
//    evaluations and gradient arithmetic are independent: the walk's
//    chain is the pair's, not each instance's) and sums the pair's 18
//    values by a transpose-reduce: recursive halving in which each lane
//    keeps half its values per step, 9+5+3+2+1 = 20 shuffles, each value
//    ending in a known lane, which writes it (12 shuffles for the nine of
//    a pair in which only one instance reaches the warp's pixels);
//  * a warp stops evaluating past its own largest live n_contrib;
//  * batches of 128 instances, staged with cp.async into a second buffer
//    while the current one is replayed; 64 registers, so 32 warps an SM;
//  * the tiles launch in the order binning computes for K1 too (heaviest
//    tile_count first), so the longest clusters start in the first wave;
//    the order of every sum is fixed inside a cluster, so the bits do not
//    depend on it.
// What holds it still: the warps of a cluster meet after every batch, so a
// batch takes its busiest warp's time (a patch under a dense splat), and a
// contributing pair costs some 70 instructions besides its 20 flops of
// evaluation; the heaviest tile is a quarter of the whole again.
//
// Rows of the output [9, L]: d_rgb (3), d_mean2d (2, in NDC units: the
// pixel gradient times 0.5 * width, 0.5 * height of the FULL frame),
// d_conic (3, the true b-gradient), d_opacity (1).  As in the reference
// the 0.99 clamp is NOT gated: d_opacity = g * d_alpha even where the
// clamp cut.  Pixels outside the image contribute nothing.
//
// Strip mode (tile-axis sharding, saro_gs_tpu/ops/tile_kernels.py:941):
// as in forward.cu, the tiles are a strip's, strip-local, its first pixel
// row y0_px, the image inputs its `rows` rows; pixel coordinates, the
// inside test and the NDC scale stay the full frame's
// (saro_gs_tpu/ops/compositing.py:168-171).

// Built with -fmad=false like K1, so the replay's decisions round as the
// forward's; the gradient arithmetic, held to its plain version by a
// tolerance only, fuses multiply-adds where it says so (fmaf).

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "alpha_chain.cuh"

namespace cg = cooperative_groups;

namespace {

using saro::kRows;
constexpr int kGrad = 9;
constexpr int kSplit = 4;          // blocks (bands of rows) per tile
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// One step of the transpose-reduce: lanes on the `upper` side of the
// butterfly keep the upper part of the slots, the others the lower part;
// each sends the part its partner keeps.  in has N slots, out (N+1)/2.
template <int N>
__device__ __forceinline__ void halve(const float (&in)[N],
                                      float (&out)[(N + 1) / 2], bool upper,
                                      int offset) {
  constexpr int H = (N + 1) / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = in[i];
    const float hi = i + H < N ? in[i + H] : 0.0f;
    const float keep = upper ? hi : lo;
    const float send = upper ? lo : hi;
    out[i] = keep + __shfl_xor_sync(kFull, send, offset);
  }
}

// Sum each of nine values over the warp's 32 lanes: 5+3+2+1+1 = 12
// shuffles.  Returns the sum that this lane holds; value is its row, or -1
// for a lane that holds none or shares it with its odd neighbour.
__device__ __forceinline__ float transpose_reduce9(const float (&v)[kGrad],
                                                   int lane, int& value) {
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4, b2 = lane & 2;
  float s5[5], s3[3], s2[2], s1[1];
  halve<9>(v, s5, b16, 16);     // slot i = value 5*b16 + i
  halve<5>(s5, s3, b8, 8);      // slot i = s5 slot 3*b8 + i
  halve<3>(s3, s2, b4, 4);      // slot i = s3 slot 2*b4 + i
  halve<2>(s2, s1, b2, 2);      // slot 0 = s2 slot b2
  const float sum = s1[0] + __shfl_xor_sync(kFull, s1[0], 1);
  const int i3 = 2 * b4 + b2;                 // slot of s3
  const int i5 = 3 * b8 + i3;                 // slot of s5
  const int idx = 5 * b16 + i5;
  value = ((lane & 1) == 0 && i3 < 3 && i5 < 5 && idx < kGrad) ? idx : -1;
  return sum;
}

// Sum each of 18 values (two instances' nine) over the warp's 32 lanes:
// 9+5+3+2+1 = 20 shuffles.  Returns the sum that this lane holds; value is
// its index (instance * 9 + row), or -1 for a lane that holds none.
__device__ __forceinline__ float transpose_reduce18(
    const float (&v)[2 * kGrad], int lane, int& value) {
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4, b2 = lane & 2,
             b1 = lane & 1;
  float s9[9], s5[5], s3[3], s2[2], s1[1];
  halve<18>(v, s9, b16, 16);    // slot i = value 9*b16 + i
  halve<9>(s9, s5, b8, 8);      // slot i = s9 slot 5*b8 + i
  halve<5>(s5, s3, b4, 4);      // slot i = s5 slot 3*b4 + i
  halve<3>(s3, s2, b2, 2);      // slot i = s3 slot 2*b2 + i
  halve<2>(s2, s1, b1, 1);      // slot 0 = s2 slot b1
  const int i3 = 2 * b2 + b1;                 // slot of s3
  const int i5 = 3 * b4 + i3;                 // slot of s5
  const int i9 = 5 * b8 + i5;                 // slot of s9
  value = (i3 < 3 && i5 < 5 && i9 < 9) ? 9 * b16 + i9 : -1;
  return s1[0];
}

// The nine values of a contributing pixel-instance pair at offset o of v:
// T is the transmittance in front of the instance, w = alpha * T its
// weight, S0..S2 the colour behind it.
template <int N>
__device__ __forceinline__ void pair_grad(
    const float* sh, int chunk, int j, const saro::Splat& s, float T,
    float w, float S0, float S1, float S2, float d0, float d1, float d2,
    float tf, float bg_dot, float half_w, float half_h, float (&v)[N],
    int o) {
  const float ca = sh[2 * chunk + j];
  const float cb = sh[3 * chunk + j];
  const float cc = sh[4 * chunk + j];
  const float c0 = sh[6 * chunk + j];
  const float c1 = sh[7 * chunk + j];
  const float c2 = sh[8 * chunk + j];
  // alpha <= 0.99: an approximate reciprocal is within 2 ulp
  const float inv = __fdividef(1.0f, 1.0f - s.alpha);
  float d_alpha = fmaf(c0, T, -S0 * inv) * d0;
  d_alpha = fmaf(fmaf(c1, T, -S1 * inv), d1, d_alpha);
  d_alpha = fmaf(fmaf(c2, T, -S2 * inv), d2, d_alpha);
  d_alpha = fmaf(-tf * inv, bg_dot, d_alpha);
  // the 0.99 clamp is not gated (backward.cu:499,538)
  const float d_g = sh[5 * chunk + j] * d_alpha;
  const float gdx = s.g * s.dx;
  const float gdy = s.g * s.dy;
  v[o + 0] = w * d0;
  v[o + 1] = w * d1;
  v[o + 2] = w * d2;
  v[o + 3] = d_g * fmaf(-gdx, ca, -gdy * cb) * half_w;
  v[o + 4] = d_g * fmaf(-gdy, cc, -gdx * cb) * half_h;
  v[o + 5] = d_g * (-0.5f * gdx * s.dx);
  v[o + 6] = d_g * (-gdx * s.dy);
  v[o + 7] = d_g * (-0.5f * gdy * s.dy);
  v[o + 8] = s.g * d_alpha;
}

__global__ void __cluster_dims__(kSplit, 1, 1)
    __launch_bounds__(kMaxThreads, 4)
backward_kernel(const int* __restrict__ order, const int* __restrict__ bound,
                const int* __restrict__ tile_start,
                const float* __restrict__ attr, int L, int width, int height,
                int grid_x, int tile_x, int tile_y, int y0_px, int rows,
                int chunk, const float* __restrict__ bg,
                const int* __restrict__ n_contrib,
                const float* __restrict__ out_color,
                const float* __restrict__ final_t,
                const float* __restrict__ d_color, float* __restrict__ grad) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + kRows * chunk};   // [kRows][chunk] each
  float* part = smem + 2 * kRows * chunk;         // [nwarps][chunk][kGrad]
  // [2][kGrad][chunk]: the band's sums, alternate batches in alternate
  // halves, so that one cluster barrier a batch keeps a half that other
  // blocks may still read from being overwritten
  float* bpart = part + nwarps * chunk * kGrad;

  const int t = order[blockIdx.x / kSplit];
  const int limit = bound[t];
  const int start = tile_start[t];
  // this block's band of rows, and the thread's pixel in it: warps take
  // 8x4 patches where the band allows, else consecutive pixels
  const int y0 = rank * tile_y / kSplit;
  const int bw = tile_x;
  const int bh = (rank + 1) * tile_y / kSplit - y0;
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
  const bool inside = p_ok && px < width && ly_buf < rows && py < height;
  const size_t hw = (size_t)rows * width;
  const size_t pix = (size_t)ly_buf * width + px;

  // a pixel outside the image replays nothing (nc = 0)
  int nc = inside ? n_contrib[pix] : 0;
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
  const float pxf = (float)px;
  const float pyf = (float)py;
  float T = 1.0f;

  // the warp's pixel box (of the pixels inside the image), for the cull
  const float wx0 = (float)__reduce_min_sync(kFull, inside ? px : INT_MAX);
  const float wx1 = (float)__reduce_max_sync(kFull, inside ? px : INT_MIN);
  const float wy0 = (float)__reduce_min_sync(kFull, inside ? py : INT_MAX);
  const float wy1 = (float)__reduce_max_sync(kFull, inside ? py : INT_MIN);
  const float diag2 = (wx1 - wx0) * (wx1 - wx0) + (wy1 - wy0) * (wy1 - wy0);

  if (limit > 0)
    saro::stage_batch_async(buf[0], attr, L, start, min(chunk, limit), chunk);
  int cur = 0;
  // every block of the cluster walks every batch: they meet after each
  for (int b0 = 0; b0 < limit; b0 += chunk) {
    const int nb = min(chunk, limit - b0);
    if (b0 + chunk < limit) {
      saro::stage_batch_async(buf[cur ^ 1], attr, L, start + b0 + chunk,
                              min(chunk, limit - b0 - chunk), chunk);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* sh = buf[cur];
    // this warp's own replay bound in the batch; its partials start at
    // zero, and only instances that some pixel of the warp takes write
    const int wl = min(nb, max(0, __reduce_max_sync(kFull, nc) - b0));
    float* my_part = part + (size_t)warp * chunk * kGrad;
    for (int i = lane; i < nb * kGrad; i += 32) my_part[i] = 0.0f;
    __syncwarp();
    for (int g = 0; g < wl; g += 32) {
      // lane i asks whether instance g + i can reach the warp's patch
      // (alpha_chain.cuh, the test the forward culls by)
      const int jl = g + lane;
      const bool reach = jl < wl && saro::warp_may_reach(
          sh, chunk, jl, wx0, wx1, wy0, wy1, diag2);
      // the live instances two at a time: their alpha evaluations and
      // gradient arithmetic are independent, and one reduce serves both
      for (unsigned live = __ballot_sync(kFull, reach); live != 0u;) {
        const int j1 = g + __ffs(live) - 1;
        live &= live - 1u;
        const bool has2 = live != 0u;
        const int j2 = has2 ? g + __ffs(live) - 1 : j1;
        if (has2) live &= live - 1u;
        saro::Splat s1, s2;
        const bool ev1 = saro::eval_alpha(sh, chunk, j1, pxf, pyf, s1);
        const bool ev2 = saro::eval_alpha(sh, chunk, j2, pxf, pyf, s2);
        // the forward's walk in order: j1's latch may end the pixel before
        // j2 (the instance that would take T below 1e-4 does not count)
        const bool ok1 = ev1 && b0 + j1 < nc;
        const float t1 = T * (1.0f - s1.alpha);
        if (ok1 && t1 < saro::kTEps) nc = 0;
        const bool con1 = ok1 && !(t1 < saro::kTEps);
        const float T1 = con1 ? t1 : T;
        const bool ok2 = has2 && ev2 && b0 + j2 < nc;
        const float t2 = T1 * (1.0f - s2.alpha);
        if (ok2 && t2 < saro::kTEps) nc = 0;
        const bool con2 = ok2 && !(t2 < saro::kTEps);
        const unsigned any1 = __ballot_sync(kFull, con1);
        const unsigned any2 = __ballot_sync(kFull, con2);
        if (any1 != 0u && any2 != 0u) {
          // both instances' values on every lane, kept where they count;
          // S becomes the colour behind each instance in turn
          float v[2 * kGrad];
          const float w1 = s1.alpha * T;
          if (con1) {
            S0 = fmaf(-w1, sh[6 * chunk + j1], S0);
            S1 = fmaf(-w1, sh[7 * chunk + j1], S1);
            S2 = fmaf(-w1, sh[8 * chunk + j1], S2);
          }
          pair_grad(sh, chunk, j1, s1, T, w1, S0, S1, S2, d0, d1, d2, tf,
                    bg_dot, half_w, half_h, v, 0);
          const float w2 = s2.alpha * T1;
          if (con2) {
            S0 = fmaf(-w2, sh[6 * chunk + j2], S0);
            S1 = fmaf(-w2, sh[7 * chunk + j2], S1);
            S2 = fmaf(-w2, sh[8 * chunk + j2], S2);
          }
          pair_grad(sh, chunk, j2, s2, T1, w2, S0, S1, S2, d0, d1, d2, tf,
                    bg_dot, half_w, half_h, v, kGrad);
#pragma unroll
          for (int r = 0; r < kGrad; ++r) {
            v[r] = con1 ? v[r] : 0.0f;
            v[kGrad + r] = con2 ? v[kGrad + r] : 0.0f;
          }
          int value;
          const float sum = transpose_reduce18(v, lane, value);
          if (value >= 0)
            my_part[(value < kGrad ? j1 * kGrad + value
                                   : j2 * kGrad + value - kGrad)] = sum;
        } else if ((any1 | any2) != 0u) {
          // one of the two has pixels here (the other keeps its zeros, and
          // none of its lanes moves S)
          const bool first = any1 != 0u;
          const int j = first ? j1 : j2;
          const saro::Splat sj = first ? s1 : s2;
          const float Tj = first ? T : T1;
          const bool con = first ? con1 : con2;
          const float w = sj.alpha * Tj;
          if (con) {
            S0 = fmaf(-w, sh[6 * chunk + j], S0);
            S1 = fmaf(-w, sh[7 * chunk + j], S1);
            S2 = fmaf(-w, sh[8 * chunk + j], S2);
          }
          float v[kGrad];
          pair_grad(sh, chunk, j, sj, Tj, w, S0, S1, S2, d0, d1, d2, tf,
                    bg_dot, half_w, half_h, v, 0);
#pragma unroll
          for (int r = 0; r < kGrad; ++r) v[r] = con ? v[r] : 0.0f;
          int value;
          const float sum = transpose_reduce9(v, lane, value);
          if (value >= 0) my_part[j * kGrad + value] = sum;
        }
        T = con2 ? t2 : T1;
      }
    }
    __syncthreads();
    // the band's sums: the warps' partials in warp order
    float* band_sum = bpart + (cur * kGrad) * chunk;
    for (int i = tid; i < kGrad * nb; i += blockDim.x) {
      const int r = i / nb;
      const int j = i - r * nb;
      float acc = 0.0f;
      for (int w = 0; w < nwarps; ++w)
        acc = acc + part[((size_t)w * chunk + j) * kGrad + r];
      band_sum[r * chunk + j] = acc;
    }
    cluster.sync();
    // the tile's sums: the bands in band order, one writer per value, the
    // writes shared among the cluster's blocks
    for (int i = rank * blockDim.x + tid; i < kGrad * nb;
         i += kSplit * blockDim.x) {
      const int r = i / nb;
      const int j = i - r * nb;
      float acc = 0.0f;
      for (int q = 0; q < kSplit; ++q)
        acc = acc + cluster.map_shared_rank(band_sum, q)[r * chunk + j];
      grad[(size_t)r * L + start + b0 + j] = acc;
    }
    cur ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  // no block leaves while another may still read its band sums
  if (limit > 0) cluster.sync();
}

}  // namespace

// Bytes of dynamic shared memory a block takes for these sizes.
static size_t smem_bytes(int threads, int chunk) {
  return sizeof(float) *
         (2 * kRows + (threads / 32) * kGrad + 2 * kGrad) *
         (size_t)chunk;
}

// Returns the cudaError_t of the launch (0 = success).  grad [9, L] must
// be zeroed by the caller; order [n_tiles] is a permutation of the tiles
// (the launch order), bound [n_tiles] each tile's replay bound
// (min(tile_count, the tile's largest n_contrib)); the image buffers have
// `rows` rows, the first at global pixel row y0_px (a whole frame: 0 and
// height).  A tile is a cluster of
// kSplit blocks of roundup32(tile_x * ceil(tile_y / kSplit)) <= 256
// threads; tile_y >= kSplit.
extern "C" int saro_backward_tiles(const void* order, const void* bound,
                                   const void* tile_start, const void* attr,
                                   int L, int width, int height, int grid_x,
                                   int grid_y, int tile_x, int tile_y,
                                   int y0_px, int rows, int chunk,
                                   const void* bg,
                                   const void* n_contrib,
                                   const void* out_color, const void* final_t,
                                   const void* d_color, void* grad,
                                   void* stream) {
  const int n_tiles = grid_x * grid_y;
  const int band = (tile_y + kSplit - 1) / kSplit;
  const int threads = (tile_x * band + 31) / 32 * 32;
  if (threads > kMaxThreads || tile_y < kSplit)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(threads, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  backward_kernel<<<n_tiles * kSplit, threads, smem, (cudaStream_t)stream>>>(
      (const int*)order, (const int*)bound, (const int*)tile_start,
      (const float*)attr, L, width, height, grid_x, tile_x, tile_y, y0_px,
      rows, chunk, (const float*)bg, (const int*)n_contrib,
      (const float*)out_color, (const float*)final_t, (const float*)d_color,
      (float*)grad);
  return (int)cudaGetLastError();
}
