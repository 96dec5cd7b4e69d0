"""The window's arithmetic and the result's last line."""
import json

from gsbench.common import drive, harness, registry


def test_rates_over_the_whole_window():
    w = drive.Window(attempted=100, failed=0, seconds=1.2, latencies=[])
    view = registry.runner("test_render").end_to_end(None, w)
    assert view == {"render_fps": 100 / 1.2}
    tr = registry.runner("train_step_core").end_to_end(
        None, drive.Window(12, 0, 4.0, []))
    assert tr == {"train_steps_per_s": 3.0}


def test_capacity_rule():
    assert drive.capacity(437_905, 1.15, 65536) == 524288
    assert drive.capacity(10, 1.15, 65536) == 65536


def test_last_line_keys_and_checks_last():
    out = {"correct": True, "attempted": 3, "failed": 0,
           "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
           "device": {"platform": "gpu", "kind": "x", "count": 1,
                      "memory_peak_bytes": 5},
           "checks": [("frame_mae", 0.0, 1e-6)]}
    line = harness.result_line(out)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert json.loads(json.dumps(line))["checks"]["frame_mae"]["limit"] \
        == 1e-6
