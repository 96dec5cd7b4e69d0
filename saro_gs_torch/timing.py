"""Timing and tracing on the card: marks, spans and counters, in one
``Recorder``, under one switch.

Marks: ``mark(name)`` ends the stage ``name``.  Inside ``with record() as
rec:`` every mark is recorded, and ``rec.stages()`` gives, per name, the
stream milliseconds between each mark and the mark before it (so a name
stands for the stage that ends there, host gaps included), summed over
the block; ``rec.host_stages()`` gives the host's milliseconds between
the same marks, by the same names.

Spans: ``with span(name, view=i):`` is a nested interval, recorded with
its parent (the innermost open span), the id of the unit it belongs to
and its view (given, or its parent's).  ``with unit(name):`` opens a
top-level span with a new id: one frame or one step.  ``count(name, n)``
adds ``n`` to the open unit's counters.  On the card each unit's counter
``device_allocs`` is the number of device allocations
(``num_device_alloc`` of ``torch.cuda.memory_stats``) the caching
allocator made while it was open.  The open spans are process-wide, not
per thread: autograd's engine thread runs ``_Rasterize.backward``'s marks
while the thread that called ``torch.autograd.grad`` waits in its span.

Every record holds the host's clock (``time.perf_counter_ns``) and, on the
card, a CUDA event on the current stream; off the card the host's clock
is the only one, and ``stages()`` reads it.  The last recorder closed
stays readable as ``last()``.

While ``torch.profiler`` records, each span is also a host range
``saro/<name>`` over its extent and each mark a zero-length host range
``saro/<name>/end`` at its moment, so the stage ``<name>`` is the interval
between the previous ``saro/.../end`` and this one, on the timeline of
the device's kernels.

With neither a recorder nor the profiler active, ``mark``, ``span``,
``unit`` and ``count`` are one check each: ``span`` and ``unit`` return a
shared null context, no CUDA event is made and the allocator is not read.

Calls: ``event_ms`` times a function's calls by CUDA events (the host's
enqueue time included where it exceeds the work), ``device_ms`` gives the
device time of each kernel the calls launch, by ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

# The profiler's ranges: a function-scope RecordFunction.  The user scope
# of ``torch.autograd.profiler.record_function`` would also put each range
# on the card's rows of the trace (a "gpu_user_annotation" over the
# kernels it launched), where it would read as device work.
_range = torch._C._profiler._RecordFunctionFast

_active = None   # the Recorder of the innermost ``record()`` block
_last = None     # the last Recorder closed
_open = []       # the recorded spans still open, innermost last
_ids = itertools.count(1)
_NULL = contextlib.nullcontext()


class Record(NamedTuple):
    """One moment: the host's clock, the CUDA event recorded there (None
    off the card), the id of the unit open there (0: none) and the view of
    the innermost open span (None: none given)."""
    name: str
    host_ns: int
    event: object
    unit: int
    view: object


def _ms(r0: Record, r1: Record, host: bool) -> float:
    if host or r0.event is None:
        return (r1.host_ns - r0.host_ns) * 1e-6
    return r0.event.elapsed_time(r1.event)


class Span:
    """A recorded interval.  ``parent`` and ``unit`` are span ids (0:
    none); a unit is the span whose ``unit`` is its own ``id``, and holds
    the ``counters`` of its extent."""
    __slots__ = ("name", "id", "parent", "unit", "view", "counters",
                 "begin", "end")

    def __init__(self, name: str, is_unit: bool, view, parent):
        self.name, self.id = name, next(_ids)
        self.parent = parent.id if parent else 0
        self.unit = self.id if is_unit or not parent else parent.unit
        self.view = view if view is not None or not parent else parent.view
        self.counters = {}
        self.begin = self.end = None

    def ms(self) -> float:
        """Stream ms from open to close (host ms off the card); read after
        ``Recorder.stages()`` or a synchronize."""
        return _ms(self.begin, self.end, False)

    def host_ms(self) -> float:
        return _ms(self.begin, self.end, True)


class Recorder:
    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.marks = []   # the marks' Records, in order
        self.spans = []   # Spans, in the order they opened

    def _record(self, name: str) -> Record:
        top = _open[-1] if _open else None
        ns = time.perf_counter_ns()
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return Record(name, ns, ev, top.unit if top else 0,
                      top.view if top else None)

    def _between(self, host: bool) -> dict:
        out = {}
        for r0, r1 in zip(self.marks, self.marks[1:]):
            out[r1.name] = out.get(r1.name, 0.0) + _ms(r0, r1, host)
        return out

    def stages(self) -> dict:
        """Stream ms by stage name; call after the work has been enqueued
        (on the card it synchronizes).  The first mark only opens the
        first stage."""
        if self.cuda:
            torch.cuda.synchronize()
        return self._between(False)

    def host_stages(self) -> dict:
        """Host ms by stage name, between the marks of ``stages()``."""
        return self._between(True)

    def units(self) -> list:
        return [s for s in self.spans
                if s.id == s.unit and s.end is not None]


def _device_allocs() -> int:
    # memory_stats() without its flattening in Python
    return torch.cuda.memory_stats_as_nested_dict().get(
        "num_device_alloc", 0)


class _Scope:
    """The context of ``span`` and ``unit`` while something records."""
    __slots__ = ("name", "is_unit", "view", "rec", "span", "range",
                 "allocs")

    def __init__(self, name: str, is_unit: bool, view):
        self.name, self.is_unit, self.view = name, is_unit, view
        self.rec = self.span = self.range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.range = _range("saro/" + self.name)
            self.range.__enter__()
        rec = self.rec = _active
        if rec is not None:
            s = self.span = Span(self.name, self.is_unit, self.view,
                                 _open[-1] if _open else None)
            if self.is_unit and rec.cuda:
                self.allocs = _device_allocs()
            _open.append(s)
            s.begin = rec._record(self.name)
            rec.spans.append(s)
        return self

    def __exit__(self, *exc):
        s = self.span
        if s is not None:
            s.end = self.rec._record(self.name)
            if self.is_unit and self.rec.cuda:
                s.counters["device_allocs"] = _device_allocs() - self.allocs
            _open.remove(s)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def mark(name: str) -> None:
    """End the stage ``name`` here."""
    rec = _active
    if rec is None and not _profiler._is_profiler_enabled:
        return
    if _profiler._is_profiler_enabled:
        with _range("saro/" + name + "/end"):
            pass
    if rec is not None:
        rec.marks.append(rec._record(name))


def span(name: str, view=None):
    """A nested interval ``name`` (a context manager)."""
    if _active is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _Scope(name, False, view)


def unit(name: str):
    """A top-level span ``name`` with a new id: one frame or one step."""
    if _active is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _Scope(name, True, None)


def count(name: str, n: int) -> None:
    """Add ``n`` to the open unit's counter ``name`` (nothing with no
    unit open)."""
    if _active is None:
        return
    for s in reversed(_open):
        if s.id == s.unit:
            s.counters[name] = s.counters.get(name, 0) + n
            return


@contextlib.contextmanager
def record():
    global _active, _last
    prev, _active = _active, Recorder()
    try:
        yield _active
    finally:
        _last, _active = _active, prev


def last():
    """The last recorder closed (None before the first)."""
    return _last


def event_ms(fn, reps: int) -> float:
    """Mean ms per call of fn() over reps calls after one untimed call,
    by CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int) -> dict:
    """Device ms per call of each kernel and copy that fn() launches, by
    name (cut to 80 characters), by torch.profiler over reps calls after
    one untimed call; empty where the profiler reports no device time, or
    lost some of it (a kernel recorded a number of times that is no
    multiple of reps: late in a long process the card's trace can drop
    activity records)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            if e.count % reps:
                return {}
            key = e.key[:80]
            out[key] = (out.get(key, 0.0)
                        + e.self_device_time_total / reps / 1e3)
    return out
