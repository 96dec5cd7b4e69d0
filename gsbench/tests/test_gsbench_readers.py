"""Each per-layer reader on a recorded toy trace, and silence where there
is nothing to read."""
import statistics
from types import SimpleNamespace

import pytest

from gsbench.common import counts, registry, trace

REC = {"segment": [0.0, 1000.0],
       "device": [["forward_kernel(int const*, int)", 100.0, 300.0],
                  ["backward_kernel(int const*)", 250.0, 400.0],
                  # K5's kernels, inside other kernels' intervals
                  ["ssim_fwd_kernel(float const*)", 120.0, 170.0],
                  ["ssim_bwd_kernel(float const*)", 620.0, 660.0],
                  ["scatter_kernel(int const*)", 600.0, 700.0],
                  ["taps_kernel(float const*)", 700.0, 750.0],
                  ["void at::native::elementwise_kernel<4>()", 900.0,
                   950.0]],
       "host": [["aten::item", 400.0, 600.0],
                ["aten::_local_scalar_dense", 410.0, 590.0],
                ["train_step", 0.0, 1000.0]]}
# every frame's latency: the tail is of all of them
LAT = [0.010] * 90 + [0.030] * 10
STAGES = {"preprocess": 12.0, "binning": 6.0, "field_features": 3.0,
          "deform": 2.0, "deform_backward": 4.0,
          "reduce_preprocess_backward": 5.0, "loss": 1.0,
          "loss_backward": 2.0, "adam_guard": 0.5}


def ctx(**kw):
    base = dict(stages=STAGES, units=2, trace=REC,
                counts={"instances": [10, 30],
                        "k1": [(1e6, 1e3), (3e6, 1e3)],
                        "k3": [(2e6, 1e3)],
                        "k4": [[(0.0, 3.35e6)]],
                        "k5": [[(6.7e6, 0.0), (0.0, 3.35e6)]],
                        "flops_per_unit": [6.7e9, 6.7e9]},
                window={"units": 100, "seconds": 10.0,
                        "latencies": LAT})
    base.update(kw)
    return SimpleNamespace(**base)


def test_trace_arithmetic():
    assert trace.busy_intervals(REC) == [[100.0, 400.0], [600.0, 750.0],
                                         [900.0, 950.0]]
    assert abs(trace.busy_s(REC) - 500e-6) < 1e-15
    gaps = trace.idle_gaps(REC)
    assert gaps[0] == ["aten::item > aten::_local_scalar_dense",
                       pytest.approx(200e-6)]
    assert gaps[1] == ["train_step", pytest.approx(150e-6)]
    assert len(gaps) == 4
    assert trace.device_ops(REC)[0][0] == "K1: forward_kernel"
    assert trace.kernel_s(REC, counts.KERNELS["K4"]) == pytest.approx(
        150e-6)
    # the port's kernels summed under their kernel's id
    ops = dict(trace.device_ops(REC))
    assert ops["K1: forward_kernel"] == pytest.approx(200e-6)
    assert ops[("K4: " + "/".join(counts.KERNELS["K4"]))[:80]] == \
        pytest.approx(150e-6)
    assert ops[("K5: " + "/".join(counts.KERNELS["K5"]))[:80]] == \
        pytest.approx(90e-6)
    assert len(ops) == 5


EXPECT = {
    "deform_preprocess_ms.render": 6.0, "binning_ms.render": 3.0,
    "instances_per_frame.render": 20.0,
    "k1_roofline.render": 100 * (4e6 / counts.PEAK_F32) / 200e-6,
    "idle_share.render": 100 * (1 - 250e-6 * 10), "idle_share.train":
    100 * (1 - 250e-6 * 10),
    "mfu.render": 100 * 6.7e9 * 10 / counts.PEAK_F32,
    "mfu.train": 100 * 6.7e9 * 10 / counts.PEAK_F32,
    "field_ms.train": 1.5, "deform_ms.train": 3.0,
    "preprocess_ms.train": 8.5, "loss_ms.train": 1.5, "adam_ms.train": 0.25,
    "k3_roofline.train": 100 * (2e6 / counts.PEAK_F32) / 150e-6,
    "k4_roofline.train": 100 * (3.35e6 / counts.PEAK_BYTES) / 150e-6,
    "k5_roofline.train": 100 * (6.7e6 / counts.PEAK_F32
                                + 3.35e6 / counts.PEAK_BYTES) / 90e-6,
    "busy_ms.render": 0.25, "busy_ms.train": 0.25,
    "frame_ms_p95.host": 1e3 * statistics.quantiles(
        LAT, n=100, method="exclusive")[94],
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(name):
    bench = registry.load()
    assert name in {m["name"] for m in bench["per_layer"]}
    assert registry.reader(name)(ctx()) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_silent_without_data(name):
    empty = ctx(stages={}, trace={"segment": [0.0, 1.0], "device": [],
                                  "host": []},
                counts={}, window={"units": 0, "seconds": 0.0,
                                   "latencies": []})
    assert registry.reader(name)(empty) is None
