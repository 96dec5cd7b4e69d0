"""Neural3D COLMAP preprocessing from the command line (counterpart of the
top-level prep.py; the reference's helper3dg.py):

    python -m saro_gs_torch.prep --videopath <scene_dir> [--startframe 0]
        [--duration 300] [--no-colmap]

<scene_dir> holds cam<k>.mp4 videos and poses_bounds.npy; the run writes
one colmap_<i>/ directory per frame with its sparse model
(``data/preprocess.py:prepare_neural3d``).  It needs ffmpeg, and colmap
unless --no-colmap, on PATH; the host does all of it.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from .data.preprocess import prepare_neural3d

    p = argparse.ArgumentParser(prog="python -m saro_gs_torch.prep")
    p.add_argument("--videopath", required=True)
    p.add_argument("--startframe", type=int, default=0)
    p.add_argument("--duration", type=int, default=300)
    p.add_argument("--no-colmap", action="store_true",
                   help="write frame dirs, input.db and manual models only")
    args = p.parse_args(argv)
    prepare_neural3d(args.videopath, duration=args.duration,
                     start=args.startframe, run_colmap=not args.no_colmap)


if __name__ == "__main__":
    main()
