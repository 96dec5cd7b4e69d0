"""Command-line drivers: train and test (counterpart of cli.py; the
reference's train.py and test.py).

    python -m saro_gs_torch.cli train -s <data_dir> --config <json> \\
        [--model_path <out>] [--device cuda]
    python -m saro_gs_torch.cli test -m <out> [--iteration best]

They write what the JAX package's CLI writes: cfg_args.json,
cameras.json, history.json, exp_log.txt, <it>_runtimeresults.json and
checkpoints under point_cloud/ (train); the render dumps under
test/ours_<it>/ and <it>_runtimeresults.json (test).  ``--device``
defaults to ``cuda``.

Training on several processes (a mesh of mesh_data x mesh_tile ranks in
the config; parallel/runtime.py):

    torchrun --nproc_per_node N -m saro_gs_torch.cli train -s <data_dir> \
        --config <json> [--device cpu]

Rank r takes card LOCAL_RANK % device_count; only rank 0 writes.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from . import DEFAULT_DEVICE


def train_main(argv=None):
    from .config import load_config, save_cfg_args
    from .eval import quick_test_report
    from .parallel import runtime
    from .scene import Scene
    from .train.trainer import Trainer

    p = argparse.ArgumentParser(prog="saro_gs_torch.cli train")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--model_path", "-m", default="")
    p.add_argument("--exp_name", default="default")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--backend", default=None, choices=["pallas", "jax"],
                   help="the JAX package's rasterizer choice; here it picks "
                        "the tiling that backend uses")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--quiet", action="store_true",
                   help="accepted as the JAX CLI accepts it; changes nothing")
    p.add_argument("--start_checkpoint", default=None,
                   help="warm-start from a point_cloud.ply (+ sibling .npz) "
                        "checkpoint (reference --checkpoint, train.py:70-71)")
    p.add_argument("--start_iteration", type=int, default=None,
                   help="resume the LR/densify/stage schedules at this "
                        "iteration (with --start_checkpoint)")
    args = p.parse_args(argv)

    rank = runtime.init_distributed(device=args.device)
    if runtime.group_size() > 1:
        print(f"[multi-process] rank {rank}/{runtime.group_size()}",
              flush=True)
    writer = rank == 0
    device = runtime.rank_device(args.device)
    overrides = {"source_path": args.source_path,
                 "exp_name": args.exp_name}
    if args.model_path:
        overrides["model_path"] = args.model_path
    if args.iterations is not None:
        overrides["iterations"] = args.iterations
    if args.backend:
        overrides["raster_backend"] = args.backend
    cfg = load_config(args.config, **overrides)
    if not cfg.model_path:
        cfg.model_path = os.path.join("log", cfg.dataset or "scene",
                                      cfg.exp_name)
    if writer:
        os.makedirs(cfg.model_path, exist_ok=True)
        save_cfg_args(cfg, os.path.join(cfg.model_path, "cfg_args.json"))
    if not cfg.testing_iterations:
        cfg.testing_iterations = [cfg.test_iteration] + [
            i for i in range(cfg.densify_until_iter, cfg.iterations)
            if i % 500 == 0]

    scene = Scene(cfg, device=device)
    if args.start_checkpoint:
        scene.load_checkpoint(args.start_checkpoint)
        print(f"warm-start from {args.start_checkpoint}: "
              f"{int((scene.alive > 0).sum())} points")
    trainer = Trainer(cfg, scene)
    if args.start_iteration:
        trainer.state = trainer.state._replace(step=args.start_iteration)
        # a worse eval after the resume must not replace iteration_best
        for pth in glob.glob(os.path.join(cfg.model_path,
                                          "*_runtimeresults.json")):
            try:
                with open(pth) as f:
                    prev = json.load(f).get("PSNR") or 0.0
            except (OSError, ValueError):
                continue
            trainer.best_psnr = max(trainer.best_psnr, prev)
        print(f"resuming schedules at iteration {args.start_iteration} "
              f"(best PSNR so far {trainer.best_psnr:.2f})")
    # the initial z-floater prune of COLMAP scenes (train.py:128-134)
    if cfg.densify in (1, 2, 4):
        st = trainer.state
        trainer.state = st._replace(alive=st.alive.masked_fill(
            st.points.xyz[:, 2] < 4.5, 0.0))
        print(f"After z<4.5 prune: {trainer.n_alive()} points")
    scene.record_points(0, "start training", trainer.n_alive())

    def eval_fn(tr, it):
        rec = {"iteration": it, **quick_test_report(tr, scene.test_cameras())}
        print(f"[eval {it}] test PSNR {rec['PSNR']:.2f} SSIM "
              f"{rec['SSIM']:.4f} MS-SSIM {rec['MS-SSIM']:.4f} (per-view std "
              f"{rec['PSNR_spread']['std']:.2f})")
        with open(os.path.join(cfg.model_path, f"{it}_runtimeresults.json"),
                  "w") as f:
            json.dump(rec, f, indent=True)
        if rec["PSNR"] >= tr.best_psnr:
            tr.best_psnr = rec["PSNR"]
            print(f"[eval {it}] saving best checkpoint")
            scene.save(it, tr.state.points, tr.state.nets, tr.state.alive,
                       best_ckpt=True)

    trainer.run(eval_fn=eval_fn)
    scene.save(trainer.state.step, trainer.state.points, trainer.state.nets,
               trainer.state.alive)
    if writer:
        with open(os.path.join(cfg.model_path, "history.json"), "w") as f:
            json.dump(trainer.history, f)
    return trainer


def test_main(argv=None):
    from .config import load_cfg_args
    from .eval import Evaluator
    from .scene import Scene

    p = argparse.ArgumentParser(prog="saro_gs_torch.cli test")
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", default="best")
    p.add_argument("--require_segment", action="store_true")
    p.add_argument("--skip_val", action="store_true")
    p.add_argument("--backend", default=None, choices=["pallas", "jax"])
    p.add_argument("--device", default=DEFAULT_DEVICE)
    args = p.parse_args(argv)

    cfg = load_cfg_args(os.path.join(args.model_path, "cfg_args.json"))
    cfg.model_path = args.model_path
    if args.backend:
        cfg.raster_backend = args.backend
    scene = Scene(cfg, load_iteration=args.iteration, device=args.device)
    ev = Evaluator(cfg, scene)
    results = ev.render_set(
        "test", scene.test_cameras(), scene.params, scene.nets, scene.alive,
        iteration=args.iteration, require_segment=args.require_segment)
    print(json.dumps(results, indent=2))
    if not args.skip_val and scene.val_cameras():
        ev.render_set("val", scene.val_cameras(), scene.params, scene.nets,
                      scene.alive, iteration=args.iteration,
                      measure_fps=False, has_gt=False)
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    commands = {"train": train_main, "test": test_main}
    if not argv or argv[0] not in commands:
        sys.exit("usage: python -m saro_gs_torch.cli {train,test} ...")
    commands[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
