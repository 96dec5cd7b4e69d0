"""The ``train_step_core`` runner: a trainer's closed loop of steps
through ``saro_gs_torch.train.step.train_step_core``.  The check compares
the first steps from the benchmark's inputs, run twice through the same
step (in set-up, and again once the window has closed, on the warmed
path), with the reference's steps from the same inputs on the same
views."""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from gsbench.common import counts, drive, port, scene
from gsbench.reference import model as ref_model
from gsbench.reference import precision
from gsbench.reference import render as ref_render
from gsbench.reference import step as ref_step


class Runner(drive.Runner):
    """``train_step_core`` in the dynamic stage at the configuration's
    LRs and loss weights, Adam from zero moments: each step takes
    ``batch`` distinct views of the capture drawn from the seed (the first
    ``check_steps`` steps' views all differ; ``capture_views`` says what a
    view is) and as many images of a uint8 ground-truth pool made from the
    seed."""

    def setup(self):
        tr, dev = self.traffic, self.dev
        self.inp = inp = scene.make_inputs(self.cfg, self.seed, dev)
        self.port = p = port.build(drive.source_config(self.cfg), inp)
        g = scene.generator(self.seed + 1, dev)
        self.pool = scene.gt_pool(int(tr["gt_pool"]), inp.width,
                                  inp.height, g, dev)
        self.view_cam, self.view_time, probe = capture_views(
            self.cfg, len(inp.centers), dev)
        schedule, pool_idx = draw(len(self.view_cam), tr, self.seed)
        self.schedule = torch.as_tensor(schedule, device=dev)
        self.pool_idx = torch.as_tensor(pool_idx, device=dev)
        cam_of = self.view_cam.tolist()
        with torch.no_grad():
            feat = port.gm.field_feat(p.params, p.nets, p.mcfg, p.fstatic)
            need = 0
            for v in probe:
                pkg = port.train_render(
                    port.camera(inp.cams, cam_of[v]),
                    self.view_time[v].reshape(1, 1),
                    p.params, p.nets, p.alive, p.mcfg, p.fstatic, inp.bg,
                    width=inp.width, height=inp.height, stage="dynamatic",
                    sh_degree=int(tr["sh_degree"]), rcfg=p.rcfg, feat=feat)
                need = max(need, pkg.out.num_instances + pkg.out.num_dropped)
            del feat, pkg
        self.need = need
        self.max_instances = drive.capacity(need, tr["probe_pad"],
                                      int(tr["probe_round"]))
        sm = port.step_mod
        self.st = sm.StepStatics(
            mcfg=p.mcfg, rcfg=p.rcfg._replace(max_instances=self.max_instances),
            weights=p.cfg.loss_weights(), width=inp.width, height=inp.height,
            cfg_lrs=sm.make_lr_statics(p.cfg), extent=inp.extent)
        # the checked steps go through the window's own call and feed
        self.checked = [self.checked_steps()]
        drive.sync(dev)

    def checked_steps(self) -> dict:
        """The schedule's first ``check_steps`` steps from the benchmark's
        inputs (a fresh state of the port's same model: the leaves copied
        back, zero moments), through ``step``: each step's metrics, the
        norms of Adam's first moments after the first step and of each
        leaf's change after the last.  The state is left after them."""
        p, inp = self.port, self.inp
        self.state = port.step_mod.init_state(port.restore(p.nets, inp), p.nets,
                                              inp.alive.clone())
        self.s = 0
        first = []
        for i in range(int(self.traffic["check_steps"])):
            first.append(self.step())
            if i == 0:
                mu1 = self._norms(port.mu_leaves(self.state))
        now = port.leaves(self.state)
        return {"losses": [m["loss"] for m in first], "mu1": mu1,
                "change": self._norms({k: now[k] - inp.leaves[k]
                                       for k in now}),
                "bad": sum(bool(m["bad_step"] or m["dropped"])
                           for m in first)}

    def after_window(self):
        """The checked steps again, on the path the window has warmed."""
        self.checked.append(self.checked_steps())
        drive.sync(self.dev)

    @staticmethod
    def _norms(tensors: dict) -> dict:
        vals = torch.stack([torch.linalg.vector_norm(t.double())
                            for t in tensors.values()]).tolist()
        return dict(zip(tensors, vals))

    def views(self, s: int):
        """Step ``s``'s views: (view indices, cameras, ground truth,
        times)."""
        k = s % self.schedule.shape[0]
        v = self.schedule[k]
        return (v, port.camera(self.inp.cams, self.view_cam[v]),
                self.pool[self.pool_idx[k]],
                self.view_time[v].reshape(-1, 1, 1))

    def step(self) -> dict:
        """The next step of the schedule; returns its metrics."""
        _, cams, gt, ts = self.views(self.s)
        self.s += 1
        state = self.state
        if self.fault == "half_batch":
            half = gt.shape[0] // 2
            cams = type(cams)(*[c[:half] for c in cams])
            gt, ts = gt[:half], ts[:half]
        if self.fault == "unchanged":
            state = port.step_mod.clone_state(state)
        new, m = port.step_mod.train_step_core(
            state, cams, gt, ts, self.inp.bg, self.port.fstatic, self.st,
            stage="dynamatic", sh_degree=int(self.traffic["sh_degree"]),
            scale_integral=bool(self.traffic["scale_integral"]))
        if self.fault != "unchanged":
            self.state = new
        return m

    def window(self, seconds: float) -> drive.Window:
        lat, failed, n = [], 0, 0
        drive.sync(self.dev)
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            m = self.step()
            failed += bool(m["bad_step"] or m["dropped"])
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            n += 1
            if t1 - start >= seconds:
                break
        drive.sync(self.dev)
        return drive.Window(attempted=n, failed=failed,
                      seconds=time.perf_counter() - start, latencies=lat)

    def end_to_end(self, w: drive.Window) -> dict:
        return {"train_steps_per_s": w.attempted / w.seconds}

    def traced(self, units: int):
        """The profiled steps keep the state each step starts from, for
        ``counts``, without allocating inside the segments: each leaf is
        copied into buffers allocated here, before them, from a memory pool
        of their own (on the card), since buffers or held leaves that came
        from the allocator's cached blocks would make the step allocate
        anew."""
        self.traced_steps = []

        def buffers():
            return [{k: torch.empty_like(v)
                     for k, v in port.leaves(self.state).items()}
                    for _ in range(units)]
        if self.dev.type == "cuda":
            self.snap_pool = torch.cuda.MemPool()
            with torch.cuda.use_mem_pool(self.snap_pool):
                bufs = buffers()
        else:
            bufs = buffers()

        def one(profiled):
            if profiled:
                snap = bufs[len(self.traced_steps)]
                with torch.no_grad():
                    for k, v in port.leaves(self.state).items():
                        snap[k].copy_(v)
                self.traced_steps.append((self.s, snap))
            self.step()
        return self._traced(units, one)

    def counts(self) -> dict:
        """K1's, K3's, K4's and K5's work in each traced step, and the
        step's operations, counted on the reference's path from the state
        the step started from."""
        sc = self.ref_scene()
        w, h, tile = sc.width, sc.height, sc.tile
        nt = -(-w // tile) * -(-h // tile)
        live = self.inp.live
        k1, k3, k4, k5, flops = [], [], [], [], []
        for s, leaves in self.traced_steps:
            _, cams, gt, ts = self.views(s)
            feat = ref_step.feat_of(sc, leaves)
            f_pairs = 0
            for i in range(gt.shape[0]):
                cam = ref_render.Camera(*[c[i] for c in cams])
                d = ref_model.deform(sc.m, leaves, feat, sc.duration, ts[i],
                                     with_residuals=True)
                c = count_view(d, cam, sc)
                k1.append(counts.k1(c["walked"], c["valid"], nt, w, h))
                k3.append(counts.k3(c["replayed"], c["contributing"],
                                    c["valid"], nt, w, h))
                k5.append(counts.k5(w, h))
                f_pairs += k1[-1][0] + k3[-1][0]
            planes = self.plane_work(live)
            k4.append(planes)
            flops.append(self.step_flops(live, int(gt.shape[0]), f_pairs,
                                         planes))
        return {"k1": k1, "k3": k3, "k4": k4, "k5": k5,
                "flops_per_unit": flops}

    def plane_work(self, rows: int) -> list:
        """(flops, bytes) of K4 on each plane for ``rows`` live rows."""
        out = []
        combs = ref_model.COMBS * len(self.m.multires)
        for (a, b), (c, hh, ww) in zip(combs,
                                       ref_model.plane_shapes(self.m)):
            spatial = 3 not in (a, b)
            n_lv = ref_model.max_mip_levels(
                hh, ww, ref_model.SPATIAL_MAX_MIP if spatial else 0)
            cells = sum((hh >> lv) * (ww >> lv) for lv in range(n_lv + 1))
            out.append(counts.k4_plane(rows, c, cells, 8 if n_lv else 4,
                                       n_lv > 0))
        return out

    def step_flops(self, rows: int, views: int, pair_flops: int,
                   planes: list) -> float:
        """A step's operations: per view the heads (the four at the view's
        time, motion and rotation again at zero distance) and the
        preprocess, forward and backward (x3); K1's and K3's pairs; the
        SSIM forward and backward (x3); the field's taps forward and K4's
        scatter; Adam over the live rows and the nets."""
        hf = ref_model.head_flops_per_row(self.m)
        per_view = sum(hf.values()) + hf["motion_mlp"] + hf["rot_mlp"] \
            + counts.PREPROCESS_FLOPS_PER_ROW
        taps = 2 * sum(f for f, _ in planes)
        n_net = sum(v.numel() for k, v in self.inp.leaves.items()
                    if k not in ref_model.POINT_FIELDS)
        per_row = sum(self.inp.leaves[k][0].numel()
                      for k in ref_model.POINT_FIELDS)
        return (3 * views * rows * per_view + pair_flops
                + 3 * views * counts.ssim_flops(self.inp.width,
                                                self.inp.height)
                + taps + counts.ADAM_FLOPS_PER_PARAM * (n_net + rows * per_row))

    def release(self):
        del self.port, self.state, self.st
        self.traced_steps = []
        self.snap_pool = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_numbers(self, tf32: bool) -> dict:
        """The reference's checked steps from the benchmark's inputs on
        the same views: each step's loss, the first gradient's and Adam's
        first moment's norms by leaf, the change's norms by leaf."""
        sc = self.ref_scene()
        rs = ref_step.init_state(self.inp.leaves)
        losses, finite = [], True
        with precision.tf32(tf32):
            for s in range(int(self.traffic["check_steps"])):
                _, cams, gt, ts = self.views(s)
                b = gt.shape[0]
                rs, info = ref_step.train_step(
                    sc, rs, [ref_render.Camera(*[c[i] for c in cams])
                             for i in range(b)], gt, [ts[i] for i in range(b)],
                    bool(self.traffic["scale_integral"]),
                    int(self.traffic["sh_degree"]))
                losses.append(info["loss"])
                finite = finite and info["finite"]
                if s == 0:
                    g1, mu1 = self._norms(info["grads"]), self._norms(rs.mu)
                del info
        change = self._norms({k: rs.leaves[k] - self.inp.leaves[k]
                              for k in rs.leaves})
        return {"losses": losses, "g1": g1, "mu1": mu1, "change": change,
                "finite": finite}

    def _compare(self, prog: dict, ref: dict) -> list:
        med_g = statistics.median(ref["g1"].values())
        counted = [k for k in ref["change"] if ref["g1"][k] >= 1e-3 * med_g]
        loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                       for p, r in zip(prog["losses"], ref["losses"]))
        return [
            ("loss_gap", loss_gap, float(self.limits["loss_gap"])),
            ("grad_gap", gap(prog["mu1"], ref["mu1"], list(ref["mu1"])),
             float(self.limits["grad_gap"])),
            ("change_gap", gap(prog["change"], ref["change"], counted),
             float(self.limits["change_gap"]))]

    def check(self) -> list:
        """Three numbers against the reference's first steps from the same
        inputs on the same views, for the checked steps of set-up and
        those run again after the window, the worse of the two: each
        step's loss (the worst relative gap), the first gradient's norm
        as Adam's first moment holds it, and the norm of the parameters'
        change after the checked steps (each the worst leaf's gap over
        the larger of the reference's norm of that leaf and of the median
        leaf; the change over the leaves whose first gradient is at least
        a thousandth of the median leaf's)."""
        ref = self._ref_numbers(False)
        worst = {}
        for prog in self.checked:
            for name, value, limit in self._compare(prog, ref):
                if value >= worst.get(name, (-1.0,))[0]:
                    worst[name] = (value, limit)
        bad = sum(c["bad"] for c in self.checked) + (not ref["finite"])
        return [(n, v, lim) for n, (v, lim) in worst.items()] + [
            ("bad_checked_steps", bad, 0)]

    def control(self) -> list:
        """The same numbers with the reference in TF32 in the program's
        place."""
        return self._compare(self._ref_numbers(True),
                             self._ref_numbers(False))


def capture_views(cfg: dict, count: int, device):
    """The training views of the configuration's capture of ``count``
    cameras: each view's camera and time, and the views the capacity probe
    renders.

      * ``hemisphere`` (a D-NeRF capture): one pose a frame; view j is
        camera j at time j / (count - 1); the probe renders every view;
      * ``arc`` (a DyNeRF rig): every camera films each of the
        configuration's ``duration`` frames; view v is camera v % count at
        frame f = v // count, time f / duration (the Neural3D reader's
        stamps); the probe renders every camera at the first, middle and
        last frame.

    -> (cameras [n] int64 and times [n] float32 on ``device``, the probe's
    views as a list)."""
    layout = cfg["bench"]["cameras"]["layout"]
    if layout == "hemisphere":
        cam = torch.arange(count, device=device)
        times = torch.arange(count, device=device,
                             dtype=torch.float32) / (count - 1)
        return cam, times, list(range(count))
    if layout == "arc":
        d = int(cfg["duration"])
        v = torch.arange(count * d, device=device)
        times = (v // count).to(torch.float32) / d
        probe = [f * count + c for f in (0, d // 2, d - 1)
                 for c in range(count)]
        return v % count, times, probe
    raise ValueError(f"camera layout {layout!r}")


def draw(n_views: int, traffic: dict, seed: int):
    """The schedule from the seed: ``check_steps`` steps whose views all
    differ, then ``schedule_steps`` steps of ``batch`` distinct views each,
    out of ``n_views``; and each view's image of the ground-truth pool.
    -> (views, pool indices), int64 arrays [steps, batch]."""
    b = int(traffic["batch"])
    rng = np.random.default_rng(seed)
    first = rng.permutation(n_views)[:b * int(traffic["check_steps"])]
    rest = np.stack([rng.choice(n_views, b, replace=False)
                     for _ in range(int(traffic["schedule_steps"]))])
    views = np.concatenate([first.reshape(-1, b), rest])
    return views, rng.integers(int(traffic["gt_pool"]), size=views.shape)


def gap(prog: dict, ref: dict, names: list) -> float:
    """The worst leaf's |norm - reference norm| over the larger of the
    reference's norm and the median leaf's."""
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
               for k in names)


def count_view(d, cam, sc) -> dict:
    """One training view's instances and pairs on the reference's path:
    K1's walked pairs, K3's replayed pairs (up to each pixel's n_contrib)
    and contributing pairs."""
    with torch.no_grad():
        fr = ref_render.render(d, cam, sc.alive, sc.bg, sc.width, sc.height,
                               sc.tile, sc.m.sh_degree)
        zero = torch.zeros_like(fr.color)
        _, contrib = ref_render.compositing.backward_tiles(
            fr.bins.attr, fr.bins.tile_start, fr.bins.tile_count,
            sc.bg.to(torch.float32), fr.n_contrib, fr.color, fr.final_t,
            zero, sc.width, sc.height, sc.tile, sc.tile, count_pairs=True)
    return {"instances": fr.instances, "valid": fr.valid,
            "walked": int(fr.n_walked.sum()),
            "replayed": int(fr.n_contrib.sum()),
            "contributing": int(contrib)}
