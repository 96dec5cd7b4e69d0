"""The port's marks, spans and counters (saro_gs_torch/timing.py) on the
CPU: nothing is made while nothing records; spans nest with their parent,
unit and view, across threads; the profiler sees the ``saro/`` ranges in
order; the ``instances`` counter; the same outputs with recording on and
off; the stage names the marks had."""
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from saro_gs_torch import bench, timing
from saro_gs_torch.ops.rasterize import RasterConfig
from saro_gs_torch.render import test_render as render_view
from saro_gs_torch.render import train_render
from saro_gs_torch.ops.projection import CameraParams
from saro_gs_torch.train import step as step_mod

W, H = 64, 48
RENDER_STAGES = {"frame", "preprocess", "binning", "K1_forward"}
STEP_STAGES = {"start", "field_features", "deform", "preprocess", "binning",
               "K1_forward", "loss", "loss_backward", "K3_backward",
               "reduce_preprocess_backward", "deform_backward",
               "field_backward", "adam_guard"}


@pytest.fixture(scope="module")
def view():
    """A frame of the bench's synthetic scene at a toy size."""
    mcfg, params, nets, alive, fstatic, _ = bench.bench_scene(
        300, device="cpu")
    cam = bench.bench_camera(W, H, "cpu")
    rcfg = RasterConfig(tile_x=16, tile_y=16, max_instances=1 << 14)

    def frame(ts=0.4):
        return render_view(cam, ts, params, nets, alive, mcfg, fstatic,
                           torch.zeros(3), width=W, height=H, sh_degree=3,
                           rcfg=rcfg)[0]
    return frame


@pytest.fixture(scope="module")
def tin():
    """The bench's train step at a toy size: 2 views of 64x48."""
    return bench.train_inputs(bench.bench_scene(200, device="cpu"), W, H, 2,
                              1 << 14, "cpu")


def step(tin):
    """One step from a copy of the bench's first state."""
    return bench.train_step(tin, step_mod.clone_state(tin.state))


def test_nothing_is_made_while_nothing_records(monkeypatch, view, tin):
    def boom(*a, **k):
        raise AssertionError("made while nothing records")
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", boom)
    assert timing.span("a") is timing.span("b", view=1) is timing.unit("u")
    with timing.unit("u"), timing.span("a", view=0):
        timing.mark("m")
        timing.count("instances", 5)
    view()
    step(tin)


def test_spans_nest_with_parent_unit_and_view():
    with timing.record() as rec:
        timing.count("lost", 1)        # no unit open: counted nowhere
        with timing.unit("u"):
            timing.mark("m0")
            with timing.span("a", view=3):
                with timing.span("b"):
                    timing.mark("m1")
                    timing.count("n", 2)
                timing.count("n", 5)
        with timing.unit("u"):
            with timing.span("a"):
                timing.mark("m2")
    u, a, b, u2, a2 = rec.spans
    assert [s.name for s in rec.spans] == ["u", "a", "b", "u", "a"]
    assert (u.parent, u.unit, u.view) == (0, u.id, None)
    assert (a.parent, a.unit, a.view) == (u.id, u.id, 3)
    assert (b.parent, b.unit, b.view) == (a.id, u.id, 3)
    assert (a2.parent, a2.unit) == (u2.id, u2.id) and u2.id != u.id
    assert rec.units() == [u, u2]
    assert u.counters.get("n") == 7 and "n" not in u2.counters
    assert "lost" not in u.counters
    assert [(r.name, r.unit, r.view) for r in rec.marks] == [
        ("m0", u.id, None), ("m1", u.id, 3), ("m2", u2.id, None)]
    for s in rec.spans:
        assert s.begin.host_ns <= s.end.host_ns and s.host_ms() >= 0
    assert b.begin.host_ns >= a.begin.host_ns and b.end.host_ns <= \
        a.end.host_ns
    assert timing.last() is rec and timing._open == []


def test_backward_marks_fall_in_the_open_step(tin):
    with timing.record() as rec:
        step(tin)
        with timing.unit("u"):
            with timing.span("wait", view=7):
                # another thread marks while this one waits, as autograd's
                # engine thread does on the card
                t = threading.Thread(target=timing.mark, args=("other",))
                t.start()
                t.join(timeout=60)
        assert not t.is_alive()
    unit, u = rec.units()
    assert unit.name == "train_step" and unit.end.host_ns <= \
        u.begin.host_ns
    views = [s for s in rec.spans if s.name == "backward"]
    assert [s.view for s in views] == [0, 1]
    assert all(s.parent == unit.id and s.unit == unit.id for s in views)
    inside = [r for r in rec.marks if r.name in (
        "loss_backward", "K3_backward", "reduce_preprocess_backward")]
    assert [(r.name, r.view) for r in inside] == [
        (n, i) for i in (0, 1) for n in (
            "loss_backward", "K3_backward", "reduce_preprocess_backward")]
    assert all(r.unit == unit.id for r in rec.marks[:-1])
    assert (rec.marks[-1].name, rec.marks[-1].unit,
            rec.marks[-1].view) == ("other", u.id, 7)


def _host(prof):
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith("saro/"))


def test_profiler_sees_the_ranges_in_order(view, tin):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timing.mark("frame")
        view()
    ev = _host(prof)
    assert [n for _, _, n in ev] == [
        "saro/frame/end", "saro/test_render", "saro/deform",
        "saro/preprocess/end", "saro/binning/end", "saro/K1_forward/end"]
    (f0, _, _), (r0, r1, _), (d0, d1, _), (p0, _, _), (b0, _, _), \
        (k0, _, _) = ev
    assert f0 <= r0 <= d0 < d1 <= p0 < b0 < k0 <= r1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(tin)
    ev = _host(prof)
    names = [n for _, _, n in ev]
    assert names[0] == "saro/train_step" and names[1] == "saro/start/end"
    assert names[-1] == "saro/adam_guard/end"
    assert names.count("saro/backward") == 2
    ends = [n[5:-4] for n in names if n.endswith("/end")]
    assert ends == ["start", "field_features"] + [
        "deform", "preprocess", "binning", "K1_forward", "loss",
        "loss_backward", "K3_backward", "reduce_preprocess_backward",
        "deform_backward"] * 2 + ["field_backward", "adam_guard"]
    t0, t1, _ = ev[0]
    for a, b, n in ev[1:]:
        assert t0 <= a and b <= t1, n
    for a, b, n in ev:
        if n == "saro/backward":
            inner = [m for x, _, m in ev if a <= x <= b and m != n]
            assert inner == ["saro/loss_backward/end", "saro/K3_backward/end",
                             "saro/reduce_preprocess_backward/end"]


def test_instances_counter_is_the_sum_of_num_instances(view, tin):
    with timing.record() as rec:
        out = view()
        _, m = step(tin)
    frame, train = rec.units()
    assert frame.counters["instances"] == out.num_instances
    st, state = tin.st, tin.state
    want = 0
    with torch.no_grad():
        for i in range(tin.gt.shape[0]):
            want += train_render(
                CameraParams(*[x[i] for x in tin.cams]), tin.timestamps[i],
                state.points, state.nets, state.alive, st.mcfg, tin.fstatic,
                tin.bg, width=W, height=H, stage="dynamatic", sh_degree=3,
                rcfg=st.rcfg).out.num_instances
    assert want > 0
    assert train.counters["instances"] == m["instances"] == want


def test_outputs_equal_with_recording_on_and_off(view, tin):
    plain = view().color
    s0, m0 = step(tin)
    with timing.record():
        rec_color = view().color
        s1, m1 = step(tin)
    with profile(activities=[ProfilerActivity.CPU]):
        prof_color = view().color
        s2, m2 = step(tin)
    assert torch.equal(plain, rec_color) and torch.equal(plain, prof_color)
    assert m0 == m1 == m2
    for other in (s1, s2):
        for a, b in zip(step_mod.param_leaves(s0.points, s0.nets),
                        step_mod.param_leaves(other.points, other.nets)):
            assert torch.equal(a, b)


def test_stages_keep_their_names(monkeypatch, view, tin):
    def boom(*a, **k):
        raise AssertionError("synchronized without a card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    with timing.record() as rec:
        for _ in range(2):
            timing.mark("frame")
            view()
    assert set(rec.stages()) == set(rec.host_stages()) == RENDER_STAGES
    with timing.record() as rec:
        step(tin)
        step(tin)
    assert set(rec.stages()) == set(rec.host_stages()) == STEP_STAGES
    assert all(v >= 0 for v in rec.host_stages().values())
    # one step: the first mark only opens the first stage
    with timing.record() as rec:
        step(tin)
    assert set(rec.stages()) == STEP_STAGES - {"start"}
