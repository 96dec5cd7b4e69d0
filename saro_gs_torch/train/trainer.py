"""Training driver: the train step in a host loop with density control
(counterpart of train/trainer.py; the reference's train.py:56-303).

Each iteration takes a batch from the scene's loader, runs
``step.train_step_core`` (renders, loss, gradients, densify statistics,
LR schedules, Adam, the non-finite guard) and then the host-side control
the reference also runs outside autograd: the stage switch, the
every-50-iterations integral prune and LR refresh, densify/prune and
opacity resets (helper_train.controlgaussians:103-174), the SH degree
ramp, eval, checkpoints, and instance-capacity doubling when a view
dropped instances.  When a densify pass runs out of dead slots the
capacity doubles and the pass runs again.

The split draws come from the scene's generator, on the CPU, so a run
draws the same numbers on every device.

With ``mesh_data * mesh_tile`` > 1 the run is one rank of a process group
(parallel/runtime.py; launched by torchrun): each rank holds the whole
state, takes its data index's share of every batch, renders its strip of
tile rows, and the step's collectives give every rank the same update.
The host-side control then runs alike on every rank (same state, same
generator seed).  Only rank 0 evaluates and writes into ``model_path``
(checkpoints, history.json, exp_log.txt, the eval report; the JAX
package writes from every process), and the other ranks wait at a
barrier after each eval.

Not ported, because they exist only for XLA or the TPU: the background
precompile of the dynamic step and the device-scalar caches of the SH
mask and flags; wandb logging is left out.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..models import densify as dens
from ..models import gaussians as gm
from ..ops.projection import CameraParams
from ..parallel import runtime
from ..render import train_render
from . import optim, step

_N_POINT_LEAVES = len(gm.GaussianParams._fields)


def grow_state(state: step.TrainState, factor: int = 2) -> step.TrainState:
    """``state`` with every per-Gaussian tensor padded to ``factor`` times
    the capacity: the points, their Adam moments, ``alive`` and the
    statistics with zeros (rotation too: the new rows are dead), the LR
    scalings with ones.  The nets and their moments are kept as they
    are."""
    old = state.alive.shape[0]
    extra = old * factor - old

    def pad(x, fill=0.0):
        return torch.cat([x, x.new_full((extra,) + tuple(x.shape[1:]),
                                        fill)])

    k = _N_POINT_LEAVES
    return state._replace(
        points=gm.GaussianParams(*[pad(x) for x in state.points]),
        opt=optim.AdamState(
            mu=[pad(x) for x in state.opt.mu[:k]] + state.opt.mu[k:],
            nu=[pad(x) for x in state.opt.nu[:k]] + state.opt.nu[k:],
            count=state.opt.count),
        alive=pad(state.alive),
        aux=dens.DensifyAux(*[pad(x) for x in state.aux]),
        inv_integral=pad(state.inv_integral, 1.0),
        inv_integral_densify=pad(state.inv_integral_densify, 1.0))


class Trainer:
    """Trains ``scene``'s model on the scene's device."""

    def __init__(self, cfg, scene):
        self.cfg = cfg
        self.scene = scene
        self.device = scene.device
        self.mcfg = cfg.model_config()
        self.rcfg = cfg.raster_config()
        self.weights = cfg.loss_weights()
        cam0 = scene.info.train_cameras[0]
        self.width, self.height = cam0.width, cam0.height
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0],
            device=self.device)
        self.active_sh_degree = 0
        self.best_psnr = 0.0
        self.generator = scene.generator
        self.state = step.init_state(scene.params, scene.nets, scene.alive)
        self.history = []
        # one record per densify pass, and (iteration, most dropped) per
        # instance-capacity doubling
        self.densify_log = []
        self.overflows = []
        # this rank's place on the (data, tile) mesh; None for one process
        self.mesh = (runtime.make_mesh(cfg.mesh_data, cfg.mesh_tile)
                     if cfg.mesh_data * cfg.mesh_tile > 1 else None)
        self._check_tile_divisibility()
        if cfg.presize_instances and scene.info.train_cameras:
            self._presize_instances()

    def _check_tile_divisibility(self):
        """The field features are sampled point-sharded over the tile axis
        only when it divides the capacity (step.batch_loss_fn), else on
        every rank whole; say so, since the capacity is chosen here."""
        n_tile = self.cfg.mesh_tile
        cap = self.state.alive.shape[0]
        if n_tile > 1 and cap % n_tile != 0:
            print(f"[warn] capacity {cap} not divisible by mesh_tile "
                  f"{n_tile}: the field features are sampled whole on "
                  "every rank")

    def _presize_instances(self):
        """Size the instance capacity from one probe frame (as the eval
        render does), with densify headroom: a multiple of 64k, at least
        one."""
        cam = self.scene.info.train_cameras[0]
        st = self.state
        with torch.no_grad():
            pkg = train_render(
                cam.raster_params(self.device), cam.timestamp, st.points,
                st.nets, st.alive, self.mcfg, self.scene.fstatic, self.bg,
                width=self.width, height=self.height, stage="static",
                sh_degree=0, rcfg=self.rcfg)
        need = pkg.out.num_instances + pkg.out.num_dropped
        cap = max(-(-int(need * self.cfg.presize_factor) // 65536) * 65536,
                  65536)
        if cap != self.rcfg.max_instances:
            print(f"[presize] probe {need} instances -> max_instances "
                  f"{self.rcfg.max_instances} -> {cap}")
            self.rcfg = self.rcfg._replace(max_instances=cap)

    def _statics(self) -> step.StepStatics:
        return step.StepStatics(
            mcfg=self.mcfg, rcfg=self.rcfg, weights=self.weights,
            width=self.width, height=self.height,
            cfg_lrs=step.make_lr_statics(self.cfg),
            extent=self.scene.cameras_extent,
            scale_floor=self.cfg.scale_floor)

    # ---- density control ----------------------------------------------------
    def _integral_refresh(self, use_integral: bool):
        st = self.state
        integral = gm.temporal_integral(st.points, st.nets, self.mcfg,
                                        self.scene.fstatic)
        alive, inv = dens.integral_prune_and_lr(st.alive, integral,
                                                self.mcfg.min_intergral,
                                                clip=self.cfg.inv_lr_clip)
        self.state = st._replace(
            alive=alive,
            inv_integral=inv if use_integral else torch.ones_like(inv),
            inv_integral_densify=inv)

    def _densify(self, with_size_threshold: bool) -> dens.DensifyResult:
        """One densify pass over ``self.state``; returns its result (the
        state is not replaced)."""
        cfg, st = self.cfg, self.state
        cap = st.alive.shape[0]
        samples = [torch.randn((cap, 3), generator=self.generator)
                   .to(self.device) for _ in range(2)]
        integral = gm.temporal_integral(st.points, st.nets, self.mcfg,
                                        self.scene.fstatic)
        k = _N_POINT_LEAVES
        return dens.densify_pruneclone(
            st.points, gm.GaussianParams(*st.opt.mu[:k]),
            gm.GaussianParams(*st.opt.nu[:k]), st.alive, st.aux, samples,
            grad_threshold=cfg.densify_grad_threshold,
            min_opacity=cfg.opthr, extent=self.scene.cameras_extent,
            percent_dense=cfg.percent_dense,
            max_screen_size=(cfg.max_screen_size if with_size_threshold
                             else None),
            inv_integral=st.inv_integral_densify, integral=integral,
            min_intergral=self.mcfg.min_intergral,
            prune_z=cfg.loader == "colmap", prune_big_ws=cfg.pw,
            min_scale_abs=cfg.prune_min_scale * self.scene.cameras_extent)

    def _apply_densify(self, res: dens.DensifyResult):
        st = self.state
        k = _N_POINT_LEAVES
        opt = st.opt._replace(mu=list(res.mu) + st.opt.mu[k:],
                              nu=list(res.nu) + st.opt.nu[k:])
        self.state = st._replace(points=res.params, opt=opt,
                                 alive=res.alive, aux=res.aux)

    def _reset_opacity(self):
        st = self.state
        k = _N_POINT_LEAVES
        params, mu, nu = dens.reset_opacity(
            st.points, gm.GaussianParams(*st.opt.mu[:k]),
            gm.GaussianParams(*st.opt.nu[:k]))
        opt = st.opt._replace(mu=list(mu) + st.opt.mu[k:],
                              nu=list(nu) + st.opt.nu[k:])
        self.state = st._replace(points=params, opt=opt)

    def _zprune_real_xyz(self):
        """The floater prune on base-time deformed positions
        (helper_train.py:138-142)."""
        st = self.state
        with torch.no_grad():
            d = gm.deform(st.points, st.nets, self.mcfg, self.scene.fstatic,
                          0.0, with_residuals=True)
        self.state = st._replace(alive=dens.prune_mask_only(
            st.alive, d.real_xyz[:, 2] < 4.5))

    def n_alive(self) -> int:
        return int((self.state.alive > 0).sum())

    def grow_capacity(self, factor: int = 2):
        """Pad every per-Gaussian tensor to ``factor`` times the rows."""
        old = self.state.alive.shape[0]
        self.state = grow_state(self.state, factor)
        print(f"[capacity] grown {old} -> {old * factor}")

    def _sh_mask(self, active_degree: int) -> torch.Tensor:
        """[K, 1] mask of the SH coefficients up to the active degree, over
        all the allocated ones (dc + rest)."""
        k = 1 + self.state.points.features_rest.shape[1]
        return (torch.arange(k, device=self.device)
                < (active_degree + 1) ** 2).to(torch.float32)[:, None]

    def stage_at(self, iteration: int) -> str:
        # the reference's name for the dynamic stage
        return ("dynamatic" if iteration > self.cfg.static_iteration
                else "static")

    def integral_flags(self, iteration: int):
        cfg = self.cfg
        if cfg.all_no_intergral:
            return False, False
        use = True if cfg.use_intergral_afterdensify else \
            iteration <= cfg.densify_until_iter
        scale = iteration <= cfg.densify_until_iter
        return use, scale

    def _to_device(self, batch):
        def t(x):
            return torch.as_tensor(x).to(self.device, non_blocking=True)
        return runtime.make_global_batch(
            (CameraParams(*[t(x) for x in batch.cams]), t(batch.gt),
             t(batch.timestamps)))

    # ---- the loop -----------------------------------------------------------
    def run(self, max_iterations: Optional[int] = None,
            log_every: int = 50, eval_fn=None):
        cfg = self.cfg
        total = max_iterations or cfg.iterations
        loader = self.scene.train_loader(
            cfg.batch, num_workers=cfg.data_workers, seed=cfg.seed,
            process_index=self.mesh.data_rank if self.mesh else 0,
            process_count=cfg.mesh_data)
        it = self.state.step
        bad_seen = self.state.bad_steps
        prof = None
        t_start = time.time()
        try:
            for batch in loader:
                it += 1
                if it > total:
                    break
                if cfg.profile_dir and it == cfg.profile_iters[0]:
                    prof = self._start_profile()
                stage = self.stage_at(it)
                use_int, scale_int = self.integral_flags(it)
                if stage == "dynamatic" and it % 50 == 0:
                    self._integral_refresh(use_int)
                cams, gt, ts = self._to_device(batch)
                self.state, metrics = step.train_step_core(
                    self.state, cams, gt, ts, self.bg, self.scene.fstatic,
                    self._statics(), stage=stage, sh_degree=cfg.sh_degree,
                    scale_integral=scale_int,
                    sh_mask=self._sh_mask(self.active_sh_degree),
                    mesh=self.mesh)

                if prof is not None and it == cfg.profile_iters[1]:
                    self._stop_profile(prof)
                    prof = None
                if cfg.nan_check and not math.isfinite(metrics["loss"]):
                    # the reference asserts on NaN t-center gradients
                    # (saro_gaussian.py:278-279)
                    raise FloatingPointError(f"non-finite loss at it {it}")
                if cfg.use_shs and it % 1000 == 0:
                    self.active_sh_degree = min(self.active_sh_degree + 1,
                                                cfg.sh_degree)

                self._density_control(it, stage)

                # the step keeps the most instances any view dropped since
                # the last check; read it on a stride
                if it % cfg.overflow_check_every == 0:
                    hwm = int(self.state.dropped_hwm)
                    if hwm > 0:
                        self.rcfg = self.rcfg._replace(
                            max_instances=self.rcfg.max_instances * 2)
                        self.overflows.append((it, hwm))
                        print(f"[warn] it {it}: up to {hwm} instances "
                              "dropped since the last check; max_instances "
                              f"-> {self.rcfg.max_instances}")
                        self.state = self.state._replace(dropped_hwm=0)
                if it % log_every == 0 or it == 1:
                    bad_seen = self._log(it, total, stage, metrics, t_start,
                                         bad_seen, log_every)
                if eval_fn is not None and it in set(cfg.testing_iterations):
                    if self.scene.writes:
                        eval_fn(self, it)
                    if self.mesh is not None:
                        dist.barrier()
                if it in set(cfg.save_iterations):
                    self.scene.save(it, self.state.points, self.state.nets,
                                    self.state.alive)
        finally:
            loader.close()
            if prof is not None:
                self._stop_profile(prof)
        return self.state

    def _log(self, it, total, stage, metrics, t_start, bad_seen, log_every):
        rec = {"it": it, "stage": stage, "loss": metrics["loss"],
               "Ll1": metrics["Ll1"], "psnr": metrics["psnr"],
               "points": self.n_alive(), "elapsed_s": time.time() - t_start,
               # per-group max |grad| and the LR multiplier: the leading
               # signs of a divergence
               "gmax": {k: float(f"{v:.3g}")
                        for k, v in metrics["gmax"].items()},
               "inv_lr_max": round(metrics["inv_lr_max"], 1)}
        bad_total = self.state.bad_steps
        if bad_total > bad_seen:
            rec["bad_step"] = bad_total - bad_seen
            rec["bad_steps_total"] = bad_total
            # the gradient groups that went non-finite, when the logged
            # step itself was bad
            src = metrics["bad_src"]
            if src:
                rec["bad_src"] = step.bad_src_names(src)
            print(f"[warn] {bad_total - bad_seen} non-finite step(s) "
                  f"skipped since it {it - log_every}"
                  + (f" (this step: {rec['bad_src']})" if src else ""))
        self.history.append(rec)
        if not self.scene.writes:
            return bad_total
        print(f"[{it}/{total}] loss={rec['loss']:.5f} psnr={rec['psnr']:.2f} "
              f"pts={rec['points']} ({rec['elapsed_s']:.0f}s)", flush=True)
        # a killed run still leaves its trajectory on disk
        if self.scene.model_path and len(self.history) % 10 == 0:
            with open(os.path.join(self.scene.model_path, "history.json"),
                      "w") as f:
                json.dump(self.history, f)
        return bad_total

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        a, b = self.cfg.profile_iters
        path = os.path.join(self.cfg.profile_dir, f"trace_{a}_{b}.json")
        prof.export_chrome_trace(path)
        print(f"[profile] trace written to {path}")

    def _density_control(self, it: int, stage: str):
        """helper_train.controlgaussians:103-174 (modes 2 = Neural3D,
        5 = D-NeRF)."""
        cfg = self.cfg
        if cfg.densify not in (1, 2, 4, 5):
            return
        if it < cfg.densify_until_iter:
            if it > cfg.densify_from_iter and \
                    it % cfg.densification_interval == 0:
                before = self.n_alive()
                self.scene.record_points(it, "before densify", before)
                size = it > cfg.opacity_reset_interval
                res = self._densify(size)
                flags = self._densify_counts(res)
                grew = flags["overflowed"]
                if grew:
                    self.grow_capacity()
                    res = self._densify(size)
                    flags = self._densify_counts(res)
                self._apply_densify(res)
                after = self.n_alive()
                self.scene.record_points(it, "after densify", after)
                self.densify_log.append(dict(
                    it=it, before=before, after=after, grew=grew,
                    capacity=self.state.alive.shape[0], **flags))
            if it % cfg.opacity_reset_interval == 0:
                self._reset_opacity()
        elif cfg.densify == 2 and it % 500 == 1 and stage == "dynamatic":
            self._zprune_real_xyz()

    @staticmethod
    def _densify_counts(res: dens.DensifyResult) -> dict:
        """The pass's counts and overflow flag, in one read."""
        v = torch.stack([res.overflowed.to(torch.int32), res.n_cloned,
                         res.n_split, res.n_pruned]).tolist()
        return dict(overflowed=bool(v[0]), cloned=v[1], split=v[2],
                    pruned=v[3])
