"""The shared part of the runners.  A runner drives one entry point of
the port with the inputs of ``scene`` and reads a traffic mix's
parameters; it is the class ``Runner`` of ``gsbench/runners/<entry>.py``,
where ``<entry>`` is the mix's ``entry`` (``registry.runner`` finds it by
that name, so a runner for another entry point is a new file):

  * ``test_render``: one viewer in a closed loop;
  * ``train_step_core``: a trainer's closed loop of steps.

A runner's life in a run: ``setup`` (inputs, the port's model, the
capacity probe, warm-up; a trainer's first steps), ``window`` (the timed
loop), optionally ``traced`` (a short segment under the profiler and the
port's stage marks) and ``counts`` (the work of the traced units, counted
by the benchmark's own code), ``after_window`` (what the check reads from
the warmed path once the window has closed), then ``release`` (the
program's state freed) and ``check`` (the comparison with the reference
that decides ``correct``; ``control`` gives the same numbers with the
reference in TF32 in the program's place).

``fault`` breaks the timed path on purpose, for the checks' own tests:
``alter`` (a frame's image changed where it is produced), ``unchanged``
(a step that returns its state unchanged) and ``half_batch`` (half of a
step's views left out, the mean taken over the rest).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import port, trace
from ..reference import model as ref_model
from ..reference import step as ref_step


class Window(NamedTuple):
    attempted: int
    failed: int
    seconds: float
    latencies: list      # seconds, one per unit


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def capacity(need: int, pad: float, step: int) -> int:
    """The probe rule: the most instances seen, padded, rounded up."""
    return max(-(-int(need * pad) // step) * step, step)


def source_config(cfg: dict) -> dict:
    return {k: v for k, v in cfg.items() if k != "bench"}


class Runner:
    fault = None

    def __init__(self, cell: dict, cfg: dict, traffic: dict, limits: dict,
                 seed: int, device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.limits, self.seed = limits, int(seed)
        self.dev = torch.device(device)
        self.m = ref_model.model_from_config(cfg)

    def after_window(self):
        """What the check reads that the window itself does not keep."""

    def ref_scene(self) -> ref_step.Scene:
        inp = self.inp
        return ref_step.Scene(
            cfg=source_config(self.cfg), m=self.m, alive=inp.alive,
            aabb_min=inp.aabb_min, aabb_max=inp.aabb_max,
            duration=inp.duration, bg=inp.bg, width=inp.width,
            height=inp.height, tile=int(self.cfg.get("tile_size", 32)),
            extent=inp.extent)

    def _traced(self, units: int, one):
        """Two segments of ``units`` units each: the first under the
        port's stage marks alone (CUDA events; on the card only), the
        second under the profiler alone, so that neither's overhead
        enters the other's numbers.  ``one(profiled)`` runs a unit.
        -> (stage ms, trace record)."""
        from torch.profiler import ProfilerActivity, profile, record_function
        stages = {}
        if self.dev.type == "cuda":
            sync(self.dev)
            with port.timing.record() as rec:
                for _ in range(units):
                    one(False)
                sync(self.dev)
            stages = rec.stages()
        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync(self.dev)
        with profile(activities=acts) as prof:
            with record_function(trace.SEGMENT):
                for _ in range(units):
                    one(True)
                sync(self.dev)
        return stages, trace.extract(prof)
