// K2, the instance expander: duplicateWithKeys (rasterizer_impl.cu:90-112).
//
// Replaces the TPU kernel saro_gs_tpu/ops/tile_kernels.py:_expand_kernel
// (entered through expand_rows_pallas, called from
// saro_gs_tpu/ops/binning.py:bin_gaussians_staged with expander="pallas").
// The TPU version compacts the kept Gaussians with a sort and then spreads
// each Gaussian's attribute row to its slots as a windowed one-hot matmul,
// because a TPU scatter serializes.  What it computes is kept: slot s
// belongs to the LAST Gaussian g with offsets[g] <= s (offsets = exclusive
// cumsum of tiles_touched; a zero-tile Gaussian ties with its successor
// and is never the owner), and covers tile (rmin_x + l % rw,
// rmin_y + l / rw), l = s - offsets[g], in the JAX package's emission order
// (binning.py:405-408), with the corner cull (binning.py:410-429).
//
// Bound on H100: memory.  It reads 16 words per Gaussian and writes 13
// words per instance ((N*16 + MI*13)*4 bytes at 3.35 TB/s); the corner
// cull is a few tens of flops per instance.  One thread runs per slot, so
// consecutive threads write consecutive slots of every output (coalesced)
// and a splat that covers hundreds of tiles holds no warp (as one thread
// per Gaussian, writing its whole run, would).  A thread finds its slot's
// owner by binary search: two threads of the block first search the whole
// of offsets for the owners of the block's first and last slots, and
// every thread then searches only between those two (a window of some
// tens of Gaussians, cached in L1).  The lanes of a warp mostly share an
// owner, so its payload loads are broadcasts.  What holds it still: the
// two dependent searches before any write.
//
// Sort key: tile << 32 | bits(depth).  Valid depths are > 0.2 (the near
// cull), so their bits order like their values, and one stable sort of the
// keys is the stable (tile, depth) sort of binning.py:437-442 with ties in
// emission order.  Invalid slots take the sentinel tile grid_x*grid_y with
// depth 0: they sort past every real tile and never composite.
//
// Strip mode (tile-axis sharding): the rects' rows are strip-local and
// y0_tiles is the strip's first global tile row, so the cull's tile origin
// is ((ty + y0_tiles) * tile_y) in the splat means' full-frame pixels, as
// saro_gs_tpu/ops/binning.py:417-419; the keys keep strip-local tile ids.
//
// Arithmetic: built with -fmad=false and written in the plain version's
// order (tile_kernels._corner_keep), so the keep decision is bit-identical
// to PyTorch's eager ops on the same card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 10;        // x, y, conic a/b/c, opacity, r, g, b, depth
constexpr int kRowOpacity = 5;
constexpr int kRowDepth = 9;

// jnp.maximum / torch.maximum semantics: a NaN operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

constexpr int kThreads = 256;

// The last g in [lo, hi) with offsets[g] <= s, given offsets[lo] <= s and
// offsets non-decreasing.
__device__ __forceinline__ int owner_of(const int* __restrict__ offsets,
                                        int lo, int hi, int s) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= s) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ offsets, const int* __restrict__ tiles,
              const int* __restrict__ rect, const float* __restrict__ gattr,
              int n, int n_inst, int grid_x, int grid_y, int tile_x,
              int tile_y, int y0_tiles, int corner_cull,
              long long* __restrict__ keys,
              int* __restrict__ gid_out, float* __restrict__ attr) {
  // the owners of the block's first and last slots bound every owner of
  // the block's slots
  __shared__ int window[2];
  const int s_first = blockIdx.x * kThreads;
  if (threadIdx.x < 2) {
    const int s_edge = threadIdx.x == 0
        ? s_first : min(s_first + kThreads, n_inst) - 1;
    window[threadIdx.x] = owner_of(offsets, 0, n, s_edge);
  }
  __syncthreads();
  const int s = s_first + threadIdx.x;
  if (s >= n_inst) return;
  const int g = owner_of(offsets, window[0], window[1] + 1, s);
  const int l = s - offsets[g];
  const long long sentinel = (long long)grid_x * grid_y << 32;
  // slots past the last run (n_inst > the instance total) own nothing
  if (l >= tiles[g]) {
    keys[s] = sentinel;
    gid_out[s] = -1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) attr[(size_t)r * n_inst + s] = 0.0f;
    return;
  }

  const int rmin_x = rect[g];
  const int rmin_y = rect[n + g];
  const int rw = max(rect[2 * n + g] - rmin_x, 1);
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = gattr[(size_t)r * n + g];
  const int tx = rmin_x + l % rw;
  const int ty = rmin_y + l / rw;
  bool valid = true;
  if (corner_cull) {
    const float mx = v[0], my = v[1], ca = v[2], cb = v[3], cc = v[4];
    // lam_min of the conic:
    // 0.5 (ca + cc) - sqrt(0.25 (ca - cc)^2 + cb^2 + 1e-20)
    const float d = ca - cc;
    const float lam_min = 0.5f * (ca + cc) -
                          sqrtf((float)0.25 * (d * d) + cb * cb + (float)1e-20);
    const float lam_pos = max_nan(lam_min, 0.0f);
    // largest alpha over the tile's pixels bounded through the distance
    // from the mean to the tile's pixel rect
    const float px0 = (float)(tx * tile_x);
    const float py0 = (float)((ty + y0_tiles) * tile_y);
    const float ddx =
        max_nan(max_nan(px0 - mx, mx - (px0 + (float)tile_x - 1.0f)), 0.0f);
    const float ddy =
        max_nan(max_nan(py0 - my, my - (py0 + (float)tile_y - 1.0f)), 0.0f);
    const float power_bound = -0.5f * lam_pos * (ddx * ddx + ddy * ddy);
    valid = v[kRowOpacity] * expf(power_bound) >= (float)(1.0 / 255.0);
  }
  if (valid) {
    const unsigned long long depth_bits = __float_as_uint(v[kRowDepth]);
    keys[s] = ((long long)(ty * grid_x + tx) << 32) | (long long)depth_bits;
    gid_out[s] = g;
#pragma unroll
    for (int r = 0; r < kRows; ++r) attr[(size_t)r * n_inst + s] = v[r];
  } else {
    keys[s] = sentinel;
    gid_out[s] = -1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) attr[(size_t)r * n_inst + s] = 0.0f;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  One thread per
// slot; offsets is the exclusive cumsum of tiles and n_inst <= its total;
// y0_tiles is a strip's first global tile row (0 for a whole frame).
extern "C" int saro_expand_instances(const void* offsets, const void* tiles,
                                     const void* rect, const void* gattr,
                                     int n, int n_inst, int grid_x,
                                     int grid_y, int tile_x, int tile_y,
                                     int y0_tiles, int corner_cull,
                                     void* keys, void* gid, void* attr,
                                     void* stream) {
  const int blocks = (n_inst + kThreads - 1) / kThreads;
  if (blocks == 0 || n == 0) return 0;
  expand_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)offsets, (const int*)tiles, (const int*)rect,
      (const float*)gattr, n, n_inst, grid_x, grid_y, tile_x, tile_y,
      y0_tiles, corner_cull, (long long*)keys, (int*)gid, (float*)attr);
  return (int)cudaGetLastError();
}
