// K4, the field-gradient scatter: the grid gradient of one plane's mip
// sampling (ops/mip.py:sample_mip), made from the sampled points directly:
//   out[c, cell] = sum over the taps k of every point i that land on cell
//                  of weight[k] * dfeat[i, c],
// with 4 bilinear taps per bracketing mip level (two levels, or one for a
// plane without a pyramid) and the bracket's linear factor folded into the
// weight.  out is the [C, total] cotangent of the flattened pyramid.
//
// Replaces the TPU kernel saro_gs_tpu/ops/grid_scatter.py:_scatter_kernel
// (entered through scatter_taps_pallas), which answers a serial scatter
// unit: it sorts the tap rows by base cell, gives 512 cells to a grid step,
// copies chunk-aligned envelopes of the sorted table and accumulates with a
// weighted one-hot matmul.  On Hopper the fixed summation order comes from
// a stable sort by cell and a segmented reduce instead, all in this file:
//
//  1. taps_kernel: one thread per point makes its taps in the arithmetic
//     of ops/grid_scatter.py:tap_cells_weights (built with -fmad=false, so
//     every cell id and weight is the plain version's).  Tap id
//     k = (bracket * 4 + tap) * N + point; key[k] = cell, wbuf[k] = weight.
//  2. An LSD radix sort of (cell, tap id), 8 bits a pass, as many passes as
//     the key space needs (two for a 128x128 pyramid's 21,845 cells), in
//     place of a general sort over 32-bit keys.  Each pass: count_kernel
//     (per-block digit counts in shared memory), scan_kernel (a warp per
//     digit scans its counts over the blocks), scatter_kernel (stable
//     placement: a key's rank among the equal digits earlier in its warp
//     from __match_any_sync, then the warps' counts in warp order and the
//     block's rounds in order).  Integer shared-memory atomics only count;
//     nothing is placed by atomic order, so a cell's segment holds its taps
//     in tap-id order.
//  3. bounds_kernel: the segment bounds seg[cell] from the sorted keys.
//  4. piece_kernel: the sorted taps cut into fixed pieces of kPiece; one
//     warp per piece, lane = channel, walks its piece in order and sums
//     each run of one cell in a register.  A cell wholly inside a piece is
//     written out directly; a cell cut by a piece boundary leaves a partial
//     at the head or tail of each piece it crosses.
//  5. combine_kernel: one warp per cell sums a cut cell's partials in piece
//     order, and writes zero for a cell with no taps.
// No float atomics: the order of every sum is fixed by the input alone,
// and two launches agree to the bit.  A hot cell (every point on one texel)
// is spread over many warps and summed in a second, ordered pass.
//
// Bound on H100: bytes.  The function reads coords, level and dfeat once
// and writes the [C, total] output once (about 0.004 ms at the arena's
// planes); per tap and channel one multiply and one add.  What the design
// costs beyond that: the sort moves 8 bytes a tap per pass, and the reduce
// gathers one dfeat row a tap in cell order, rows of random points (from
// L2 at these sizes).  On an H100, for a 128x128 plane (659,968 taps) the
// reduce takes about 0.048 ms and the two scatter passes 0.039 of a call's
// 0.11 ms of kernels (scripts/torch_kernel_probe.py); the host's enqueue
// of the call's 10 launches is of the same order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // keys per thread per pass
constexpr int kTile = kThreads * kItems;       // keys per sort block
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kPiece = 128;                    // sorted taps per warp
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp01(float v) {
  // torch.clamp's semantics: a NaN stays NaN
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

__host__ __device__ __forceinline__ int level_base(int h, int w, int l) {
  int base = 0;
  for (int k = 0; k < l; ++k) base += (h >> k) * (w >> k);
  return base;
}

// the 4 taps of one bracket, as tap_cells_weights makes them, the weights
// multiplied by the bracket's factor
__device__ __forceinline__ void bracket_taps(float u, float v, int h, int w,
                                             int l, float factor, int bracket,
                                             int i, int n,
                                             int* __restrict__ key,
                                             float* __restrict__ wbuf) {
  const int wl = w >> l;
  const int hl = h >> l;
  const int base = level_base(h, w, l);
  const float x = u * (float)wl - 0.5f;
  const float y = v * (float)hl - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = clamp01(x - x0);
  const float fy = clamp01(y - y0);
  long long x0i = (long long)x0;
  long long y0i = (long long)y0;
  x0i = min(max(x0i, 0LL), (long long)(wl - 1));
  y0i = min(max(y0i, 0LL), (long long)(hl - 1));
  const long long x1i = min(x0i + 1, (long long)(wl - 1));
  const long long y1i = min(y0i + 1, (long long)(hl - 1));
  const int cells[4] = {base + (int)(y0i * wl + x0i),
                        base + (int)(y0i * wl + x1i),
                        base + (int)(y1i * wl + x0i),
                        base + (int)(y1i * wl + x1i)};
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  const float wts[4] = {gx * gy, fx * gy, gx * fy, fx * fy};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const size_t k = (size_t)(bracket * 4 + t) * n + i;
    key[k] = cells[t];
    wbuf[k] = wts[t] * factor;
  }
}

__global__ void __launch_bounds__(kThreads)
taps_kernel(const float* __restrict__ coords, const float* __restrict__ level,
            int n, int h, int w, int n_levels, int* __restrict__ key,
            float* __restrict__ wbuf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float u = coords[2 * (size_t)i];
  const float v = coords[2 * (size_t)i + 1];
  if (n_levels == 0) {
    bracket_taps(u, v, h, w, 0, 1.0f, 0, i, n, key, wbuf);
    return;
  }
  const float top = (float)n_levels;
  const float lv0 = level[i];
  const float lv = lv0 < 0.0f ? 0.0f : (lv0 > top ? top : lv0);
  long long l0 = (long long)floorf(lv);
  l0 = min(max(l0, 0LL), (long long)n_levels);
  const long long l1 = min(l0 + 1, (long long)n_levels);
  const float frac = lv - (float)l0;
  bracket_taps(u, v, h, w, (int)l0, 1.0f - frac, 0, i, n, key, wbuf);
  bracket_taps(u, v, h, w, (int)l1, frac, 1, i, n, key, wbuf);
}

// per sort block, the count of each digit of its kTile keys:
// counts[digit * n_blocks + block]
__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ key, int n, int shift,
             int* __restrict__ counts) {
  __shared__ int hist[kRadix];
  for (int d = threadIdx.x; d < kRadix; d += blockDim.x) hist[d] = 0;
  __syncthreads();
  const int first = blockIdx.x * kTile;
  int k[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int idx = first + r * kThreads + threadIdx.x;
    k[r] = idx < n ? key[idx] : -1;
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r)
    if (k[r] >= 0) atomicAdd(&hist[(k[r] >> shift) & (kRadix - 1)], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < kRadix; d += blockDim.x)
    counts[(size_t)d * gridDim.x + blockIdx.x] = hist[d];
}

// for each digit, an exclusive scan of its counts over the sort blocks, in
// place (one warp per digit, counts[digit * n_blocks + block] read in
// order), and the digit's total in digit_total
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ counts, int n_blocks,
            int* __restrict__ digit_total) {
  const int lane = threadIdx.x & 31;
  const int digit = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (digit >= kRadix) return;
  int* row = counts + (size_t)digit * n_blocks;
  int carry = 0;
  for (int b0 = 0; b0 < n_blocks; b0 += 32) {
    const int b = b0 + lane;
    const int x = b < n_blocks ? row[b] : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (b < n_blocks) row[b] = carry + incl - x;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) digit_total[digit] = carry;
}

// stable placement of one block's keys by one digit.  The block takes its
// keys in kItems rounds of kThreads consecutive keys; inside a round, warp
// by warp, and inside a warp, lane by lane: input order throughout.
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ key_in, const int* __restrict__ id_in,
               int n, int shift, const int* __restrict__ offsets,
               const int* __restrict__ digit_total,
               int* __restrict__ key_out, int* __restrict__ id_out) {
  __shared__ int warp_cnt[kWarps][kRadix];
  __shared__ int warp_off[kWarps][kRadix];
  __shared__ int run_off[kRadix];
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the digit's base: an exclusive scan of the digit totals (kThreads ==
  // kRadix: one digit a thread), plus this block's offset within the digit
  static_assert(kThreads == kRadix, "one digit per thread");
  const int d = threadIdx.x;
  const int tot = digit_total[d];
  int incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  for (int w = 0; w < kWarps; ++w) warp_cnt[w][d] = 0;
  __syncthreads();
  int base = incl - tot;
  for (int w = 0; w < warp; ++w) base += warp_sum[w];
  run_off[d] = base + offsets[(size_t)d * gridDim.x + blockIdx.x];
  __syncthreads();
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int first = blockIdx.x * kTile;
  // every round's keys and ids loaded up front
  int keys[kItems], ids[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int idx = first + r * kThreads + threadIdx.x;
    keys[r] = idx < n ? key_in[idx] : 0;
    ids[r] = idx < n ? (id_in != nullptr ? id_in[idx] : idx) : 0;
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int idx = first + r * kThreads + threadIdx.x;
    const bool valid = idx < n;
    const int k = keys[r];
    const int id = ids[r];
    // invalid lanes share the digit kRadix, which no valid lane has
    const int digit = valid ? (k >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(kFull, digit);
    const int rank = __popc(peers & lanemask_lt);
    if (valid && rank == 0) warp_cnt[warp][digit] = __popc(peers);
    __syncthreads();
    {
      int run = run_off[d];
      for (int w = 0; w < kWarps; ++w) {
        warp_off[w][d] = run;
        run += warp_cnt[w][d];
        warp_cnt[w][d] = 0;
      }
      run_off[d] = run;
    }
    __syncthreads();
    if (valid) {
      const int pos = warp_off[warp][digit] + rank;
      key_out[pos] = k;
      id_out[pos] = id;
    }
  }
}

// seg[c] = the first sorted position whose key is >= c, for c in
// [0, total]; each entry written once
__global__ void bounds_kernel(const int* __restrict__ key, int n, int total,
                              int* __restrict__ seg) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > n) return;
  const int prev = k > 0 ? key[k - 1] : -1;
  const int cur = k < n ? key[k] : total;
  for (int c = prev + 1; c <= cur; ++c) seg[c] = k;
}

__device__ __forceinline__ void flush_run(
    int cell, int rs, int re, int piece, const int* __restrict__ seg, int c,
    bool c_ok, int c_feat, int total, float acc, float* __restrict__ out,
    float* __restrict__ head, float* __restrict__ tail) {
  if (!c_ok) return;
  const int s = seg[cell];
  const int e = seg[cell + 1];
  if (rs == s && re == e)            // the whole segment: the output
    out[(size_t)c * total + cell] = acc;
  else if (rs == s)                  // the segment's first piece
    tail[(size_t)piece * c_feat + c] = acc;
  else                               // a later piece of the segment
    head[(size_t)piece * c_feat + c] = acc;
}

// one warp per piece of kPiece sorted taps, lane = channel.  Per batch of
// 32 taps the lanes first read the taps (lane = tap) and then the 32
// products of their channel (independent loads), then walk them in order.
__global__ void __launch_bounds__(kThreads)
piece_kernel(const int* __restrict__ key, const int* __restrict__ id,
             const float* __restrict__ wbuf, int n_taps, int n_pts,
             const float* __restrict__ dfeat, int ld, int c_feat,
             const int* __restrict__ seg, int total, float* __restrict__ out,
             float* __restrict__ head, float* __restrict__ tail) {
  const int piece = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x)
                          >> 5);
  const int lane = threadIdx.x & 31;
  const int start = piece * kPiece;
  if (start >= n_taps) return;
  const int end = min(n_taps, start + kPiece);
  for (int c0 = 0; c0 < c_feat; c0 += 32) {
    const int c = c0 + lane;
    const bool c_ok = c < c_feat;
    float acc = 0.0f;
    int cur = -1;
    int rs = start;
    for (int b = start; b < end; b += 32) {
      const int k = b + lane;
      int kl = -1, pl = 0;
      float wl = 0.0f;
      if (k < end) {
        const int t = id[k];
        kl = key[k];
        wl = wbuf[t];
        pl = t % n_pts;
      }
      float prod[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int pt = __shfl_sync(kFull, pl, j);
        const float wt = __shfl_sync(kFull, wl, j);
        prod[j] = (c_ok && b + j < end) ? wt * dfeat[(size_t)pt * ld + c]
                                        : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int cell = __shfl_sync(kFull, kl, j);
        if (b + j < end) {
          if (cell != cur) {
            if (cur >= 0)
              flush_run(cur, rs, b + j, piece, seg, c, c_ok, c_feat, total,
                        acc, out, head, tail);
            cur = cell;
            rs = b + j;
            acc = 0.0f;
          }
          acc = acc + prod[j];
        }
      }
    }
    flush_run(cur, rs, end, piece, seg, c, c_ok, c_feat, total, acc, out,
              head, tail);
  }
}

// one warp per cell: a cell cut by piece boundaries sums its partials in
// piece order; a cell with no taps is zero
__global__ void __launch_bounds__(kThreads)
combine_kernel(const int* __restrict__ seg, int c_feat, int total,
               const float* __restrict__ head,
               const float* __restrict__ tail, float* __restrict__ out) {
  const int cell = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x)
                         >> 5);
  const int lane = threadIdx.x & 31;
  if (cell >= total) return;
  const int s = seg[cell];
  const int e = seg[cell + 1];
  if (s == e) {
    for (int c = lane; c < c_feat; c += 32)
      out[(size_t)c * total + cell] = 0.0f;
    return;
  }
  const int p0 = s / kPiece;
  const int p1 = (e - 1) / kPiece;
  if (p0 == p1) return;              // piece_kernel wrote it
  // eight interleaved running sums (piece p into sum (p - p0) % 8), then
  // added pairwise: a fixed order, and shorter chains for a hot cell
  for (int c = lane; c < c_feat; c += 32) {
    float acc[8];
    acc[0] = tail[(size_t)p0 * c_feat + c];
#pragma unroll
    for (int q = 1; q < 8; ++q)
      acc[q] = p0 + q <= p1 ? head[(size_t)(p0 + q) * c_feat + c] : 0.0f;
    int p = p0 + 8;
    for (; p + 7 <= p1; p += 8) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        acc[q] = acc[q] + head[(size_t)(p + q) * c_feat + c];
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (p + q <= p1) acc[q] = acc[q] + head[(size_t)(p + q) * c_feat + c];
    out[(size_t)c * total + cell] =
        ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
        ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  }
}

int total_cells(int h, int w, int n_levels) {
  return level_base(h, w, n_levels) + (h >> n_levels) * (w >> n_levels);
}

int radix_passes(int total) {
  int bits = 0;
  while (bits < 31 && (1 << bits) < total) ++bits;
  return bits <= kRadixBits ? 1 : (bits + kRadixBits - 1) / kRadixBits;
}

struct Layout {
  int n_taps, n_blocks, n_pieces, total;
  size_t key[2], id[2], wbuf, counts, digit_total, seg, head, tail, bytes;
};

Layout layout(int n, int h, int w, int n_levels, int c_feat) {
  Layout lo;
  lo.n_taps = (n_levels > 0 ? 8 : 4) * n;
  lo.n_blocks = (lo.n_taps + kTile - 1) / kTile;
  lo.n_pieces = (lo.n_taps + kPiece - 1) / kPiece;
  lo.total = total_cells(h, w, n_levels);
  size_t at = 0;
  auto take = [&at](size_t words) {
    const size_t here = at;
    at += (words + 63) / 64 * 64;     // 256-byte aligned pieces
    return here;
  };
  for (int b = 0; b < 2; ++b) {
    lo.key[b] = take(lo.n_taps);
    lo.id[b] = take(lo.n_taps);
  }
  lo.wbuf = take(lo.n_taps);
  lo.counts = take((size_t)kRadix * lo.n_blocks);
  lo.digit_total = take(kRadix);
  lo.seg = take((size_t)lo.total + 1);
  lo.head = take((size_t)lo.n_pieces * c_feat);
  lo.tail = take((size_t)lo.n_pieces * c_feat);
  lo.bytes = at * 4;
  return lo;
}

}  // namespace

// Bytes of scratch that saro_scatter_mip_taps needs for these sizes.
extern "C" long long saro_scatter_mip_workspace(int n, int h, int w,
                                                int n_levels, int c_feat) {
  return (long long)layout(n, h, w, n_levels, c_feat).bytes;
}

// coords [n, 2] and level [n] (unused, may be null, when n_levels == 0)
// float32; dfeat [n, c_feat] float32 with row stride ld; out [c_feat,
// total] float32; workspace of saro_scatter_mip_workspace bytes, 256-byte
// aligned.  n >= 1, c_feat >= 1.  Returns the first cudaError_t.
extern "C" int saro_scatter_mip_taps(const void* coords, const void* level,
                                     const void* dfeat, int ld, int n,
                                     int c_feat, int h, int w, int n_levels,
                                     void* out, void* workspace,
                                     void* stream) {
  const Layout lo = layout(n, h, w, n_levels, c_feat);
  cudaStream_t st = (cudaStream_t)stream;
  int* ws = (int*)workspace;
  float* wsf = (float*)workspace;
  int* key[2] = {ws + lo.key[0], ws + lo.key[1]};
  int* id[2] = {ws + lo.id[0], ws + lo.id[1]};
  float* wbuf = wsf + lo.wbuf;
  int* counts = ws + lo.counts;
  int* digit_total = ws + lo.digit_total;
  int* seg = ws + lo.seg;
  float* head = wsf + lo.head;
  float* tail = wsf + lo.tail;

  taps_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)coords, (const float*)level, n, h, w, n_levels, key[0],
      wbuf);
  const int passes = radix_passes(lo.total);
  for (int p = 0; p < passes; ++p) {
    const int src = p & 1;
    const int shift = p * kRadixBits;
    count_kernel<<<lo.n_blocks, kThreads, 0, st>>>(key[src], lo.n_taps,
                                                   shift, counts);
    scan_kernel<<<kRadix * 32 / kScanThreads, kScanThreads, 0, st>>>(
        counts, lo.n_blocks, digit_total);
    scatter_kernel<<<lo.n_blocks, kThreads, 0, st>>>(
        key[src], p == 0 ? nullptr : id[src], lo.n_taps, shift, counts,
        digit_total, key[src ^ 1], id[src ^ 1]);
  }
  const int fin = passes & 1;
  bounds_kernel<<<(lo.n_taps + 1 + kThreads - 1) / kThreads, kThreads, 0,
                  st>>>(key[fin], lo.n_taps, lo.total, seg);
  const int warps_per_block = kThreads / 32;
  piece_kernel<<<(lo.n_pieces + warps_per_block - 1) / warps_per_block,
                 kThreads, 0, st>>>(key[fin], id[fin], wbuf, lo.n_taps, n,
                                    (const float*)dfeat, ld, c_feat, seg,
                                    lo.total, (float*)out, head, tail);
  combine_kernel<<<(lo.total + warps_per_block - 1) / warps_per_block,
                   kThreads, 0, st>>>(seg, c_feat, lo.total, head, tail,
                                      (float*)out);
  return (int)cudaGetLastError();
}
