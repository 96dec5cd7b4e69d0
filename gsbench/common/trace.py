"""Reading a profiled segment: the device's busy time from the union of
its operations' intervals on the trace's timeline, the idle gaps with what
the host was doing in each, and the device time by operation.

``extract`` turns a ``torch.profiler.profile`` into a plain record, so that
the readers work alike on a recorded toy trace:

    {"segment": [t0_us, t1_us],
     "device": [[name, t0_us, t1_us], ...],
     "host": [[name, t0_us, t1_us], ...]}
"""
from __future__ import annotations

from . import counts

SEGMENT = "gsbench.segment"


def extract(prof, label: str = SEGMENT) -> dict:
    device, host, seg = [], [], None
    for e in prof.events():
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        if e.name == label:
            seg = [t0, t1]
        elif e.device_type.name == "CPU":
            host.append([e.name, t0, t1])
        else:
            device.append([e.name, t0, t1])
    if seg is None:
        raise RuntimeError(f"the trace has no {label!r} range")
    return {"segment": seg, "device": device, "host": host}


def kernel_name(name: str) -> str:
    """A kernel's bare name: no namespace, return type or arguments."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    return base.strip().split(" ")[-1].split("::")[-1]


def busy_intervals(tr: dict) -> list:
    """The union of the device's operations within the segment, merged."""
    lo, hi = tr["segment"]
    spans = sorted((max(a, lo), min(b, hi)) for _, a, b in tr["device"]
                   if b > lo and a < hi)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(tr: dict) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) * 1e-6


def window_s(tr: dict) -> float:
    lo, hi = tr["segment"]
    return (hi - lo) * 1e-6


def device_ops(tr: dict, top: int = 10) -> list:
    """[[name, seconds], ...]: the operations that took the most device
    time in the segment, summed by name; the kernels of each of the port's
    hand-written kernels (``counts.KERNELS``) summed under "<id>: <their
    names>"."""
    lo, hi = tr["segment"]
    label = {k: f"{kid}: " + "/".join(names)
             for kid, names in counts.KERNELS.items() for k in names}
    tot = {}
    for name, a, b in tr["device"]:
        d = min(b, hi) - max(a, lo)
        if d > 0:
            key = label.get(kernel_name(name), name)[:80]
            tot[key] = tot.get(key, 0.0) + d * 1e-6
    return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[
        :top]


def host_at(tr: dict, t: float) -> str:
    """What the host was doing at ``t``: the two innermost host ranges
    that hold it, outer > inner."""
    inside = sorted((b - a, name) for name, a, b in tr["host"] if a <= t < b)
    if not inside:
        return "host idle"
    names = [name for _, name in inside[:2]][::-1]
    return " > ".join(names)[:120]


def idle_gaps(tr: dict, top: int = 10) -> list:
    """[[what the host was doing, seconds], ...]: the longest stretches in
    the segment that no device operation covers."""
    lo, hi = tr["segment"]
    gaps, at = [], lo
    for a, b in busy_intervals(tr):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[host_at(tr, 0.5 * (a + b)), (b - a) * 1e-6]
            for a, b in gaps[:top]]


def kernel_s(tr: dict, names) -> float:
    """Device seconds of the kernels of these names in the segment."""
    lo, hi = tr["segment"]
    names = set(names)
    return sum(min(b, hi) - max(a, lo) for n, a, b in tr["device"]
               if kernel_name(n) in names and b > lo and a < hi) * 1e-6

