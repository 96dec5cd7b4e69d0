"""Timing on the card.

Stages: named CUDA events at stage boundaries.  Off by default: ``mark``
is then one comparison.  Inside ``with record() as rec:`` every
``mark(name)`` records a CUDA event on the current stream, and
``rec.stages()`` gives, per name, the milliseconds between each mark and
the mark before it (so a name stands for the stage that ends there),
summed over the block.

Calls: ``event_ms`` times a function's calls by CUDA events (the host's
enqueue time included where it exceeds the work), ``device_ms`` gives the
device time of each kernel the calls launch, by ``torch.profiler``.
"""
from __future__ import annotations

import contextlib

import torch

_active = None


def mark(name: str) -> None:
    """End the stage ``name`` here (a no-op unless recording)."""
    if _active is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        _active.events.append((name, ev))


class Recorder:
    def __init__(self):
        self.events = []

    def stages(self) -> dict:
        """ms by stage name; call after the work has been enqueued (it
        synchronizes).  The first mark only opens the first stage."""
        torch.cuda.synchronize()
        out = {}
        for (_, e0), (name, e1) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + e0.elapsed_time(e1)
        return out


@contextlib.contextmanager
def record():
    global _active
    prev, _active = _active, Recorder()
    try:
        yield _active
    finally:
        _active = prev


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
    one untimed call; empty where the profiler reports no device time."""
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
            key = e.key[:80]
            out[key] = (out.get(key, 0.0)
                        + e.self_device_time_total / reps / 1e3)
    return out
