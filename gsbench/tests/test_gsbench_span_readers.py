"""The readers of the port's spans and counters, on a hand-made recorder
and a toy trace that carries ``saro/`` ranges, with known answers; and
silence where the spans are missing (a program without them, a run with
no card, a trace without the ranges)."""
from types import SimpleNamespace

import pytest

from gsbench.common import port, registry
from saro_gs_torch import timing

MS = 1_000_000   # ns
VIEW, TRAIN = "n3d_flame_steak.view_sweep", "dnerf_standup.train_b4"


def _recorder(marks, spans):
    """A recorder off the card: marks [(name, ms)], spans [(name, t0 ms,
    t1 ms, counters)], each span a unit where it has counters."""
    rec = timing.Recorder()
    rec.cuda = False
    rec.marks = [timing.Record(n, int(t * MS), None, 0, None)
                 for n, t in marks]
    for name, t0, t1, counters in spans:
        s = timing.Span(name, counters is not None, None, None)
        s.begin = timing.Record(name, int(t0 * MS), None, s.unit, None)
        s.end = timing.Record(name, int(t1 * MS), None, s.unit, None)
        s.counters = counters or {}
        rec.spans.append(s)
    return rec


def _frames():
    marks, spans = [], []
    for k, allocs in enumerate((4, 6)):
        t = 20 * k
        marks += [("frame", t), ("preprocess", t + 10), ("binning", t + 12),
                  ("K1_forward", t + 13)]
        spans += [("test_render", t + 0.5, t + 14, {"device_allocs": allocs}),
                  ("deform", t + 1, t + 4, None)]
    return _recorder(marks, spans)


def _steps():
    marks, spans = [], []
    for k, (allocs, inst) in enumerate(((3, 1000), (5, 3000))):
        t = 100 * k
        marks += [("start", t), ("field_features", t + 2), ("deform", t + 5),
                  ("preprocess", t + 9), ("binning", t + 10),
                  ("K1_forward", t + 11), ("loss", t + 17),
                  ("loss_backward", t + 18), ("K3_backward", t + 19),
                  ("reduce_preprocess_backward", t + 30),
                  ("deform_backward", t + 36), ("field_backward", t + 38),
                  ("adam_guard", t + 40)]
        spans.append(("train_step", t, t + 41,
                      {"device_allocs": allocs, "instances": inst}))
    return _recorder(marks, spans)


def _trace(host):
    return {"segment": [0.0, 1000.0],
            "device": [["k", 150.0, 250.0], ["k", 650.0, 700.0],
                       ["k", 450.0, 600.0]],
            "host": host}


VIEW_TRACE = _trace([["saro/test_render", 0.0, 490.0],
                     ["saro/preprocess/end", 100.0, 101.0],
                     ["saro/binning/end", 300.0, 301.0],
                     ["saro/preprocess/end", 600.0, 601.0],
                     ["saro/binning/end", 800.0, 801.0]])
TRAIN_TRACE = _trace([["saro/train_step", 0.0, 1000.0],
                      ["saro/backward", 100.0, 400.0],
                      ["saro/backward", 500.0, 900.0]])

# per unit (2 units): idle within [100, 300] and [600, 800] is 100 and
# 150 us (the view); within [100, 400] and [500, 900], 200 and 250 us
EXPECT = {
    "deform_ms.render": (VIEW, 3.0),
    "deform_preprocess_host_ms.render": (VIEW, 10.0),
    "binning_idle_ms.render": (VIEW, 0.125),
    "device_allocs_per_frame.render": (VIEW, 5.0),
    "preprocess_host_ms.train": (TRAIN, 4.0 + 11.0),
    "deform_host_ms.train": (TRAIN, 3.0 + 6.0),
    "loss_host_ms.train": (TRAIN, 6.0 + 1.0),
    "backward_idle_ms.train": (TRAIN, 0.225),
    "device_allocs_per_step.train": (TRAIN, 4.0),
    "instances_per_step.train": (TRAIN, 2000.0),
}


def _ctx(cell, rec):
    return SimpleNamespace(stages=rec.stages(), units=2,
                           trace=VIEW_TRACE if cell == VIEW else TRAIN_TRACE)


def _entry(bench, cell):
    return registry.traffic(registry.cell(bench, cell)["traffic"])["entry"]


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_span_reader(name, monkeypatch):
    cell, want = EXPECT[name]
    bench = registry.load()
    entry = {m["name"]: m for m in bench["per_layer"]}[name]
    # the cells it lists all drive the entry point its data stands for
    assert cell in entry["workloads"]
    assert {_entry(bench, w) for w in entry["workloads"]} == {
        _entry(bench, cell)}
    rec = _frames() if cell == VIEW else _steps()
    monkeypatch.setattr(timing, "_last", rec)
    assert registry.reader(name)(_ctx(cell, rec)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_span_reader_silent_without_spans(name, monkeypatch):
    cell, _ = EXPECT[name]
    rec = _frames() if cell == VIEW else _steps()
    # a program from before the spans: its timing has no last(), its
    # trace no saro/ ranges
    parent = SimpleNamespace(stages=rec.stages(), units=2,
                             trace=_trace([["_Rasterize", 0.0, 1000.0]]))
    monkeypatch.setattr(port, "timing", SimpleNamespace())
    assert registry.reader(name)(parent) is None
    monkeypatch.undo()
    # no marks segment (no card): a recorder left over is another run's
    monkeypatch.setattr(timing, "_last", rec)
    bare = SimpleNamespace(stages={}, units=2, trace={
        "segment": [0.0, 1.0], "device": [], "host": []})
    assert registry.reader(name)(bare) is None
    # an empty recorder and a trace without the ranges
    empty = _recorder([("start", 0), ("adam_guard", 1)], [])
    monkeypatch.setattr(timing, "_last", empty)
    assert registry.reader(name)(SimpleNamespace(
        stages=empty.stages(), units=2,
        trace=_trace([["saro/other", 0.0, 1000.0]]))) is None
