"""Data x tile parallel training step and tile-sharded render over the
ranks of a process group (counterpart of parallel/shard.py).

Two axes, as in the JAX package:
  * ``data``: the views of the training batch, each rank its own; the
    gradients and statistics are averaged or summed over the data group,
    which is the reference's sequential batch accumulation done at once;
  * ``tile``: strips of tile rows of every render.  Tiles are
    independent, so each rank composites its strip exactly; the
    per-Gaussian gradients are partial sums over the rank's pixels and
    are summed over the tile group.

The full rasterizer runs on each strip (``RasterConfig.strip_rows`` and
``row0``, ops/rasterize.py), the kernels K1 to K3 included.  The JAX
package's ``shard_map`` becomes one process per rank and the collectives
of comm.py; ``make_mesh`` (runtime.py) builds the mesh once, and the
functions here take it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.rasterize import RasterConfig, rasterize
from ..train import step as step_mod
from . import comm
from .runtime import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "dp_train_step", "tile_sharded_render"]


def dp_train_step(state, cams, gt, timestamps, bg, fstatic,
                  st: step_mod.StepStatics, *, stage: str, sh_degree: int,
                  scale_integral: bool, mesh: Mesh, sh_mask=None):
    """One training step on the mesh: ``cams``, ``gt`` and ``timestamps``
    are this rank's views (its data index's share of the batch; tile
    peers pass the same views), each view's render is cut into strips
    over the tile axis, and every rank ends with the same state and
    metrics (psnr aside: the rank's last view's).  The JAX package's
    ``n_data``/``n_tile`` are ``mesh``'s."""
    return step_mod.train_step_core(
        state, cams, gt, timestamps, bg, fstatic, st, stage=stage,
        sh_degree=sh_degree, scale_integral=scale_integral,
        sh_mask=sh_mask, mesh=mesh)


@torch.no_grad()
def tile_sharded_render(means3d, scales, quats, opacities, rgb_precomp,
                        cam, bg, *, width: int, height: int,
                        tile_x: int = 16, tile_y: int = 16, chunk: int = 64,
                        max_instances: int = 1 << 18, n_tile: int = 2,
                        mesh: Optional[Mesh] = None, shs=None,
                        sh_degree: int = 0,
                        config: Optional[RasterConfig] = None):
    """Forward render with the tile rows cut into ``n_tile`` strips, one a
    rank of the mesh's tile group: every rank preprocesses all the
    Gaussians, bins and composites rows_local = ceil(grid_y / n_tile)
    tile rows from its tile rank * rows_local, and the strips are
    gathered into the image [3, height, width] on every rank.  Any
    height: the grid is padded to n_tile strips and cropped.  ``mesh``
    None makes a 1 x n_tile mesh of the whole group (collective)."""
    if mesh is None:
        mesh = make_mesh(1, n_tile)
    if mesh.n_tile != n_tile:
        raise ValueError(f"n_tile {n_tile} on a mesh of {mesh.n_tile} "
                         "tile ranks")
    if config is None:
        config = RasterConfig(tile_x=tile_x, tile_y=tile_y, chunk=chunk,
                              max_instances=max_instances)
    grid_y = -(-height // config.tile_y)
    rows_local = -(-grid_y // n_tile)
    out = rasterize(means3d, scales, quats, opacities, cam, bg, width=width,
                    height=height, sh_degree=sh_degree,
                    config=config._replace(strip_rows=rows_local), shs=shs,
                    colors_precomp=None if shs is not None else rgb_precomp,
                    row0=mesh.tile_rank * rows_local)
    img = comm.gather_rows(out.color, mesh.tile_group, mesh.tile_rank,
                           n_tile, dim=1)
    return img[:, :height]
