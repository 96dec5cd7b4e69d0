#!/usr/bin/env python3
"""Where the trainer's data path costs time on the card's host: the arena
trainer of chip_smoke.py phase 12 fed from PNGs on disk against the same
images held in memory.

    python3 scripts/torch_loader_probe.py [--its 40] [--reps 2]

Writes phase 12's dataset (ground truth rendered from checkpoints/arena,
21 ring cameras at 1352x1014) under build/loader_probe/, builds the
trainer on it (configs/synth/arena.json, dynamic stage from iteration 10,
no density control) and, after 20 warm-up iterations, times in turns:

  * ``decode``: one BatchLoader batch decoded in the calling thread, ms;
  * ``loader_only``: a BatchLoader with the config's workers drained with
    no training, batches/s;
  * ``disk`` / ``memory``: ``Trainer.run`` for --its iterations with the
    ground truth decoded from the PNGs in the loader's threads, or held
    in memory (decoded once beforehand), it/s; ``disk_2`` the disk run
    with 2 loader threads.

The native decoder is used where the native image library builds (png.h
and jpeglib.h found), else PIL.  Prints one JSON line with
the card's name and power limit.  Needs one CUDA card.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import numpy as np
    import torch
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--its", type=int, default=40)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "this probe needs a CUDA card")
    from saro_gs_torch import config as cfg_mod
    from saro_gs_torch import native, scene
    from saro_gs_torch.config import load_config
    from saro_gs_torch.ops import tile_kernels as tk
    from saro_gs_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    tk.build()
    acfg = cfg_mod.load_cfg_args(os.path.join(cs.ARENA, "cfg_args.json"))
    mcfg = acfg.model_config()
    params, nets, alive, fstatic, _ = scene.load_gaussian_checkpoint(
        cs.PLY, mcfg, device=dev)
    rcfg = acfg.raster_config()._replace(need_aux=False,
                                         max_instances=1 << 20)
    info = cs.arena_scene_info(params, nets, alive, fstatic, mcfg, rcfg, dev)
    out = os.path.join(HERE, "build", "loader_probe")
    root = os.path.join(out, "scene")
    os.makedirs(out, exist_ok=True)
    cs.write_arena_dataset(info, root)
    decoder = cs.image_decoder(native)

    with open(cs.ARENA_CONFIG) as f:
        config = json.load(f)
    config.update(static_iteration=10, densify_from_iter=10 ** 9,
                  opacity_reset_interval=10 ** 9, test_iteration=10 ** 9,
                  iterations=10 ** 9, save_iterations=[], loader="blender")
    cfg_path = os.path.join(out, "arena_probe.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    cfg = load_config(cfg_path, source_path=root,
                      model_path=os.path.join(out, "model"))
    tr = Trainer(cfg, scene.Scene(cfg, device=dev))
    cams = tr.scene.info.train_cameras
    held = [c.load_image(cfg.white_background) for c in cams]

    def hold(on):
        for c, img in zip(cams, held):
            c.set_image(img if on else None)

    def run(its):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(max_iterations=tr.state.step + its, log_every=10 ** 9)
        torch.cuda.synchronize()
        return its / (time.perf_counter() - t0)

    hold(False)
    run(20)
    res = {"decoder": decoder, "its": args.its, "batch": cfg.batch,
           "data_workers": cfg.data_workers, "decode_ms": [],
           "loader_only_batches_per_s": [], "disk": [], "memory": [],
           "disk_2": []}
    workers = cfg.data_workers
    for _ in range(args.reps):
        hold(False)
        loader = tr.scene.train_loader(cfg.batch, num_workers=workers)
        try:
            t0 = time.perf_counter()
            for b in range(5):
                loader._load_batch(np.arange(b * cfg.batch,
                                             (b + 1) * cfg.batch))
            res["decode_ms"].append((time.perf_counter() - t0) * 1e3 / 5)
            it = iter(loader)
            next(it)
            t0 = time.perf_counter()
            for _ in range(20):
                next(it)
            res["loader_only_batches_per_s"].append(
                20 / (time.perf_counter() - t0))
        finally:
            loader.close()
        res["disk"].append(run(args.its))
        hold(True)
        res["memory"].append(run(args.its))
        hold(False)
        tr.cfg.data_workers = 2
        res["disk_2"].append(run(args.its))
        tr.cfg.data_workers = workers
    cs.check(tr.state.bad_steps == 0 and tr.state.dropped_hwm == 0,
             "a step went wrong")
    res["card"] = cs.smi_line()
    print(json.dumps({"loader_probe": res}), flush=True)


if __name__ == "__main__":
    main()
