"""The ``test_render`` runner: one viewer in a closed loop.  The camera
moves along the rig's arc and the time along a sine, each frame rendered
by ``saro_gs_torch.render.test_render`` and synchronized on the device;
the check compares frames drawn from the window by the seed with the
reference's render of the same camera and time."""
from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from gsbench.common import cameras, counts, drive, port, scene
from gsbench.reference import model as ref_model
from gsbench.reference import precision
from gsbench.reference import render as ref_render
from gsbench.reference import step as ref_step


class Runner(drive.Runner):
    """``test_render`` of the frames of a sweep: the camera moves along the
    rig's arc (``sweep_frames`` frames a pass, from a phase drawn from the
    seed), the timestamp is center + amplitude sin(i / period); the field
    features are computed once, as the eval path caches them; each frame
    ends when its image is synchronized on the device."""

    def setup(self):
        tr, dev = self.traffic, self.dev
        self.inp = inp = scene.make_inputs(self.cfg, self.seed, dev)
        self.port = p = port.build(drive.source_config(self.cfg), inp)
        n = int(tr["sweep_frames"])
        self.sweep = cameras.stack(
            [cameras.look_at(c)
             for c in cameras.sweep_centers(inp.centers, n)],
            scene.fovx(self.cfg), inp.width, inp.height, dev)
        self.phase = int(np.random.default_rng(self.seed).integers(n))
        with torch.no_grad():
            self.feat = port.gm.field_feat(p.params, p.nets, p.mcfg,
                                           p.fstatic)
        need = 0
        for k in range(len(inp.centers)):
            for ts in tr["probe_ts"]:
                out = self._render(port.camera(inp.cams, k), float(ts),
                                   p.rcfg)
                need = max(need, out.num_instances + out.num_dropped)
        self.need = need
        self.max_instances = drive.capacity(need, tr["probe_pad"],
                                      int(tr["probe_round"]))
        self.rcfg = p.rcfg._replace(max_instances=self.max_instances)
        self.i = -int(tr["warmup_frames"])
        for _ in range(int(tr["warmup_frames"])):
            self.frame()
        drive.sync(dev)
        self.rand = random.Random(self.seed)
        self.kept = []
        self.seen = 0
        self.peak = 0

    def _render(self, cam, ts, rcfg):
        p = self.port
        out, _ = port.test_render(
            cam, ts, p.params, p.nets, p.alive, p.mcfg, p.fstatic,
            self.inp.bg, width=self.inp.width, height=self.inp.height,
            sh_degree=int(self.traffic["sh_degree"]), rcfg=rcfg,
            feat=self.feat)
        return out

    def pose(self, i: int):
        tr = self.traffic["ts"]
        k = (self.phase + i) % int(self.traffic["sweep_frames"])
        ts = float(tr["center"]) + float(tr["amplitude"]) * math.sin(
            i / float(tr["period"]))
        return k, ts

    def frame(self):
        """Render the next frame -> (k, ts, RenderOutput)."""
        k, ts = self.pose(self.i)
        self.i += 1
        out = self._render(port.camera(self.sweep, k), ts, self.rcfg)
        if self.fault == "alter":
            out.color[0] += 0.05
        return k, ts, out

    def window(self, seconds: float) -> drive.Window:
        lat, failed, n = [], 0, 0
        keep = int(self.traffic["check_frames"])
        drive.sync(self.dev)
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            k, ts, out = self.frame()
            failed += out.num_dropped > 0
            self.peak = max(self.peak, out.num_instances + out.num_dropped)
            # reservoir sample of the frames to check, drawn from the seed
            if len(self.kept) < keep:
                self.kept.append((k, ts, out.color.clone()))
            else:
                j = self.rand.randrange(self.seen + 1)
                if j < keep:
                    self.kept[j] = (k, ts, out.color.clone())
            self.seen += 1
            drive.sync(self.dev)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            n += 1
            if t1 - start >= seconds:
                break
        return drive.Window(attempted=n, failed=failed, seconds=t1 - start,
                      latencies=lat)

    def end_to_end(self, w: drive.Window) -> dict:
        return {"render_fps": w.attempted / w.seconds}

    def traced(self, units: int):
        self.traced_frames = []

        def one(profiled):
            port.timing.mark("frame")
            k, ts, out = self.frame()
            if profiled:
                self.traced_frames.append((k, ts, out.num_instances,
                                           out.num_dropped))
        return self._traced(units, one)

    def counts(self) -> dict:
        sc = self.ref_scene()
        leaves = self.inp.leaves
        feat = ref_step.feat_of(sc, leaves)
        w, h, tile = sc.width, sc.height, sc.tile
        nt = -(-w // tile) * -(-h // tile)
        k1, inst = [], []
        for k, ts, n_inst, _ in self.traced_frames:
            fr = ref_step.eval_frame(sc, leaves, feat,
                                     ref_render.Camera(**{
                                         f: self.sweep[f][k]
                                         for f in cameras.FIELDS}), ts)
            k1.append(counts.k1(int(fr.n_walked.sum()), fr.valid, nt, w, h))
            inst.append(n_inst)
        flops = [self.frame_flops(f) for f, _ in k1]
        return {"instances": inst, "k1": k1, "flops_per_unit": flops}

    def frame_flops(self, k1_flops: int) -> float:
        """A frame's operations: the heads over the live rows, their
        preprocess, and K1's pairs."""
        heads = sum(ref_model.head_flops_per_row(self.m).values())
        rows = self.inp.live
        return rows * (heads + counts.PREPROCESS_FLOPS_PER_ROW) + k1_flops

    def release(self):
        del self.port, self.feat
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_frames(self, tf32: bool) -> list:
        """The reference's render of each sampled frame."""
        sc = self.ref_scene()
        out = []
        with precision.tf32(tf32):
            feat = ref_step.feat_of(sc, self.inp.leaves)
            for k, ts, _ in self.kept:
                cam = ref_render.Camera(**{f: self.sweep[f][k]
                                           for f in cameras.FIELDS})
                out.append(ref_step.eval_frame(sc, self.inp.leaves, feat,
                                               cam, ts).color)
        return out

    def check(self) -> list:
        """The worst mean absolute pixel error of the sampled frames
        against the reference's render of the same camera and time."""
        worst = max(float((img - ref).abs().mean()) for (_, _, img), ref
                    in zip(self.kept, self._ref_frames(False)))
        return [("frame_mae", worst, float(self.limits["frame_mae"]))]

    def control(self) -> list:
        """The same number with the reference in TF32 in the program's
        place."""
        worst = max(float((low - ref).abs().mean()) for low, ref
                    in zip(self._ref_frames(True), self._ref_frames(False)))
        return [("frame_mae", worst, float(self.limits["frame_mae"]))]
