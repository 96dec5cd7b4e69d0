"""The yardstick's arithmetic: peaks, the operations and bytes the work of
these inputs needs, kernel by kernel, and the kernels' names.

The per-pair and per-tap operation counts are those the port's smoke
script stated for K1 to K4 (chip_smoke.py:331-355), copied here so that
the benchmark owns them.  Bytes count each input byte read once and each
output byte written once.
"""
from __future__ import annotations

# H100 SXM (NVIDIA's data sheet), at its full power limit of 700 W:
# float32 outside the tensor cores, and HBM3 bytes/s
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# per evaluated instance-pixel pair in K1: dx, dy (2), power (9), min,
# expf (counted as 1), opacity * g, min, 2 cutoff compares, 1 - alpha,
# * T, the T_EPS compare
K1_FLOPS_PER_PAIR = 20
# K3, per pair it replays (the alpha as in K1), and per contributing pair:
# w, the running colour (6), 1/(1-a) (2), d_alpha (15), d_g, g*dx, g*dy
# (3), the nine values (22) and one add each into the instance's sums
K3_FLOPS_PER_REPLAYED_PAIR = 20
K3_FLOPS_PER_CONTRIBUTING_PAIR = 49 + 9
# per tap and channel in the field's sampling and in K4: a multiply, an add
TAP_FLOPS_PER_CHANNEL = 2
# one Gaussian's preprocess for one view (ops/projection.py, forward):
# view depth and projection (26), 3D covariance from scale and quaternion
# (64), the EWA 2D covariance (90), conic and radius (18), pixel mean and
# the tight and 3-sigma rects (51), SH degree 3 colour with its direction
# (150); rounded to 400
PREPROCESS_FLOPS_PER_ROW = 400
# one Adam update of one parameter with its weight decay and moments
ADAM_FLOPS_PER_PARAM = 15

# the CUDA kernels of each hand-written kernel of the port, by the name the
# profiler gives them (the part before the argument list)
KERNELS = {
    "K1": ("forward_kernel",),
    "K2": ("expand_kernel",),
    "K3": ("backward_kernel",),
    "K4": ("taps_kernel", "count_kernel", "scan_kernel", "scatter_kernel",
           "bounds_kernel", "piece_kernel", "combine_kernel"),
    "K5": ("ssim_fwd_kernel", "ssim_mean_kernel", "ssim_bwd_kernel"),
}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / PEAK_F32, nbytes / PEAK_BYTES)


def k1(pairs: int, valid: int, n_tiles: int, width: int, height: int):
    """(flops, bytes) of one forward composite."""
    return (pairs * K1_FLOPS_PER_PAIR,
            10 * 4 * valid + 8 * n_tiles + 5 * 4 * width * height)


def k3(replayed: int, contributing: int, valid: int, n_tiles: int,
       width: int, height: int):
    """(flops, bytes) of one backward composite."""
    return (replayed * K3_FLOPS_PER_REPLAYED_PAIR
            + contributing * K3_FLOPS_PER_CONTRIBUTING_PAIR,
            (10 + 9) * 4 * valid + 8 * n_tiles + 8 * 4 * width * height)


def k4_plane(rows: int, channels: int, cells: int, taps: int, levels: bool):
    """(flops, bytes) of one plane's scatter of the field's gradient:
    coordinates (and levels) and the rows' gradients read once, the
    pyramid's cells written once."""
    nbytes = rows * 8 + (rows * 4 if levels else 0) + rows * channels * 4 \
        + channels * cells * 4
    return rows * taps * channels * TAP_FLOPS_PER_CHANNEL, nbytes


def ssim_flops(width: int, height: int) -> int:
    """Forward of one view's SSIM: five blurs of three channels, each two
    11-tap passes of a multiply and an add, and the map's 18 operations a
    pixel."""
    return (5 * 2 * 11 * 2 + 18) * 3 * width * height


def k5(width: int, height: int) -> list:
    """[(flops, bytes)] of one view's SSIM forward and of its backward:
    forward ``ssim_flops`` with both images read; backward both images read
    and d img1 written (the work the function needs: no intermediate
    terms)."""
    image = 3 * width * height * 4
    return [(ssim_flops(width, height), 2 * image), (0, 3 * image)]
