"""Reading the port's spans and counters (``saro_gs_torch/timing.py``):
the recorder of the traced run's marks segment, which the port keeps as
``timing.last()`` (reached through ``port.timing``), and the ``saro/``
ranges the port puts on the profiled segment's timeline.  Each helper
gives None where there is nothing to read: a program without spans, a run
without a card (no marks segment), a trace without the range."""
from __future__ import annotations

from . import port, trace


def recorder(ctx):
    """The marks segment's recorder, or None.  Without the segment's
    stages (no card) any recorder left in the process is another run's."""
    last = getattr(port.timing, "last", None)
    if last is None or not ctx.stages:
        return None
    return last()


def host_ms(ctx, names) -> float:
    """Host ms a unit of these stages together."""
    rec = recorder(ctx)
    if rec is None or not ctx.units:
        return None
    st = rec.host_stages()
    parts = [st.get(k) for k in names]
    return None if None in parts else sum(parts) / ctx.units


def span_ms(ctx, name: str) -> float:
    """Stream ms a unit of the spans ``name`` together."""
    rec = recorder(ctx)
    if rec is None or not ctx.units:
        return None
    ms = [s.ms() for s in rec.spans if s.name == name and s.end is not None]
    return sum(ms) / ctx.units if ms else None


def per_unit(ctx, counter: str) -> float:
    """The mean of a counter over the recorded units that hold it."""
    rec = recorder(ctx)
    vals = [] if rec is None else [u.counters[counter] for u in rec.units()
                                   if counter in u.counters]
    return sum(vals) / len(vals) if vals else None


def ranges(tr: dict, name: str) -> list:
    """[(t0, t1)] of the host ranges ``saro/<name>``, in time order."""
    return sorted((a, b) for n, a, b in tr["host"] if n == "saro/" + name)


def between(tr: dict, first: str, then: str) -> list:
    """[(t0, t1)]: from each mark ``then``'s moment back to the latest mark
    ``first`` before it (the stage ``then`` where ``first`` precedes it)."""
    opens = [a for a, _ in ranges(tr, first + "/end")]
    out = []
    for t1, _ in ranges(tr, then + "/end"):
        before = [t for t in opens if t <= t1]
        if before:
            out.append((before[-1], t1))
    return out


def idle_ms(ctx, intervals: list) -> float:
    """Device-idle ms a unit within these intervals of the trace's
    timeline: their length less the union of the device's operations
    over them."""
    if not intervals or not ctx.trace["device"] or not ctx.units:
        return None
    busy = trace.busy_intervals(ctx.trace)
    idle = 0.0
    for a, b in intervals:
        idle += (b - a) - sum(max(0.0, min(b, y) - max(a, x))
                              for x, y in busy)
    return 1e-3 * idle / ctx.units
