// K2, the instance expander: duplicateWithKeys (rasterizer_impl.cu:90-112).
//
// Replaces the TPU kernel saro_gs_tpu/ops/tile_kernels.py:_expand_kernel
// (entered through expand_rows_pallas, called from
// saro_gs_tpu/ops/binning.py:bin_gaussians_staged with expander="pallas").
// The TPU version compacts the kept Gaussians with a sort and then spreads
// each Gaussian's attribute row to its slots as a windowed one-hot matmul,
// because a TPU scatter serializes.  On Hopper a scatter is cheap, so this
// kernel runs one thread per Gaussian: thread g walks the slots it owns,
// [offsets[g], offsets[g] + tiles[g]) clipped to n_inst, in the JAX
// package's emission order (local slot l covers tile rmin_x + l % rw,
// rmin_y + l / rw, binning.py:405-408), applies the corner cull
// (binning.py:410-429) and writes the slot's sort key, Gaussian id and
// attribute payload.  Culled and zero-tile Gaussians own no slots.
//
// Bound on H100: memory.  It reads 16 words per Gaussian and writes about
// 13 words per instance ((N*16 + MI*13)*4 bytes at 3.35 TB/s); the corner
// cull is a few tens of flops per instance.  The design keeps each
// Gaussian's payload in registers and writes every slot exactly once; the
// writes of neighbouring threads are not coalesced (each thread writes its
// own run of slots), which a later version can fix with one thread per
// slot and a binary search for the owner.
//
// Sort key: tile << 32 | bits(depth).  Valid depths are > 0.2 (the near
// cull), so their bits order like their values, and one stable sort of the
// keys is the stable (tile, depth) sort of binning.py:437-442 with ties in
// emission order.  Invalid slots take the sentinel tile grid_x*grid_y with
// depth 0: they sort past every real tile and never composite.
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

__global__ void expand_kernel(const int* __restrict__ offsets,
                              const int* __restrict__ tiles,
                              const int* __restrict__ rect,
                              const float* __restrict__ gattr, int n,
                              int n_inst, int grid_x, int grid_y, int tile_x,
                              int tile_y, int corner_cull,
                              long long* __restrict__ keys,
                              int* __restrict__ gid_out,
                              float* __restrict__ attr) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int off = offsets[g];
  int cnt = tiles[g];
  // culled Gaussians (tiles_touched 0) and those past capacity own nothing
  if (cnt <= 0 || off >= n_inst) return;
  cnt = min(cnt, n_inst - off);   // capacity: slots >= n_inst are dropped

  const int rmin_x = rect[g];
  const int rmin_y = rect[n + g];
  const int rw = max(rect[2 * n + g] - rmin_x, 1);
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = gattr[(size_t)r * n + g];
  const float mx = v[0], my = v[1], ca = v[2], cb = v[3], cc = v[4];
  const float op = v[kRowOpacity];
  const unsigned long long depth_bits = __float_as_uint(v[kRowDepth]);
  const long long sentinel = (long long)grid_x * grid_y << 32;

  // lam_min of the conic, per Gaussian (same for all its slots):
  // 0.5 (ca + cc) - sqrt(0.25 (ca - cc)^2 + cb^2 + 1e-20)
  const float d = ca - cc;
  const float lam_min = 0.5f * (ca + cc) -
                        sqrtf((float)0.25 * (d * d) + cb * cb + (float)1e-20);
  const float lam_pos = max_nan(lam_min, 0.0f);
  const float alpha_min = (float)(1.0 / 255.0);

  for (int l = 0; l < cnt; ++l) {
    const int s = off + l;
    const int tx = rmin_x + l % rw;
    const int ty = rmin_y + l / rw;
    bool valid = true;
    if (corner_cull) {
      // largest alpha over the tile's pixels bounded through the distance
      // from the mean to the tile's pixel rect
      const float px0 = (float)(tx * tile_x);
      const float py0 = (float)(ty * tile_y);
      const float ddx =
          max_nan(max_nan(px0 - mx, mx - (px0 + (float)tile_x - 1.0f)), 0.0f);
      const float ddy =
          max_nan(max_nan(py0 - my, my - (py0 + (float)tile_y - 1.0f)), 0.0f);
      const float power_bound = -0.5f * lam_pos * (ddx * ddx + ddy * ddy);
      valid = op * expf(power_bound) >= alpha_min;
    }
    if (valid) {
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
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
extern "C" int saro_expand_instances(const void* offsets, const void* tiles,
                                     const void* rect, const void* gattr,
                                     int n, int n_inst, int grid_x,
                                     int grid_y, int tile_x, int tile_y,
                                     int corner_cull, void* keys, void* gid,
                                     void* attr, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (blocks == 0) return 0;
  expand_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)offsets, (const int*)tiles, (const int*)rect,
      (const float*)gattr, n, n_inst, grid_x, grid_y, tile_x, tile_y,
      corner_cull, (long long*)keys, (int*)gid, (float*)attr);
  return (int)cudaGetLastError();
}
