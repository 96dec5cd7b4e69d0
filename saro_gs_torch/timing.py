"""Stage timing on the card: named CUDA events at stage boundaries.

Off by default: ``mark`` is then one comparison.  Inside
``with record() as rec:`` every ``mark(name)`` records a CUDA event on the
current stream, and ``rec.stages()`` gives, per name, the milliseconds
between each mark and the mark before it (so a name stands for the stage
that ends there), summed over the block.
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
