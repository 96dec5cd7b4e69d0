"""Configuration: one dataclass, the JAX package's JSON configs 1:1.

Same field names and defaults as ``saro_gs_tpu/config.py``, so
``configs/**/*.json`` and a checkpoint's ``cfg_args.json`` load unchanged.
The TPU kernel flags (``raster_prefix``, ``raster_packed``,
``raster_expander``, ``raster_alpha_matmul``) are parsed and ignored: the
port has one compositor and one expander.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

from .models.field import FieldConfig
from .models.gaussians import ModelConfig
from .ops.rasterize import RasterConfig
from .train.losses import LossWeights


@dataclasses.dataclass
class Config:
    # ---- data / model (ModelParams) ----
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = True
    loader: str = "colmap"
    use_loader: bool = True
    sh_degree: int = 3
    deform_hidden_dim: int = 128
    deform_time_encode: int = 4
    dx: bool = True
    drot: bool = True
    dopacity: bool = True
    dsh: bool = False
    use_shs: bool = True
    scale_reg: bool = False
    shs_reg: bool = False
    motion_reg: bool = False
    kplanes_config: dict = dataclasses.field(default_factory=lambda: {
        "grid_dimensions": 2, "input_coordinate_dim": 4,
        "output_coordinate_dim": 32, "resolution": [64, 64, 64, 25]})
    multires: List[int] = dataclasses.field(default_factory=lambda: [1, 2,
                                                                     4, 8])
    planemodel: str = "scale_aware"
    min_intergral: float = 0.1
    integral_renorm: bool = False
    min_interval: float = 1.0
    sigmoid_tcenter: bool = False
    pw: bool = False
    duration: int = 50
    densify: int = 0
    dataset: str = ""
    exp_name: str = "default"

    # ---- optimization (OptimizationParams) ----
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    trbfc_lr: float = 0.0001
    trbfc_lr_final: float = 0.0000001
    batch: int = 2
    mlp_lr: float = 1.6e-4
    mlp_lr_final: float = 1.6e-7
    hexplane_lr: float = 3.2e-3
    hexplane_lr_final: float = 3.2e-6
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_dtstd: float = 0.0
    lambda_dscale_reg: float = 0.0
    lambda_dshs_reg: float = 0.0
    lambda_dmotion_reg: float = 0.0
    lambda_dplanetv: float = 0.0
    lambda_dtime_smooth: float = 0.0
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 9_000
    densify_grad_threshold: float = 0.0002
    opthr: float = 0.005
    preprocesspoints: int = 40
    static_iteration: int = -1
    use_intergral_afterdensify: bool = True
    all_no_intergral: bool = False
    use_weight_decay: bool = False
    test_iteration: int = 20001

    # ---- rasterizer / runtime ----
    capacity: int = 1 << 18
    raster_backend: str = "pallas"
    tile_size: int = 32
    max_instances: int = 1 << 20
    max_slots: int = 4096
    chunk: int = 128
    # TPU kernel flags of the JAX package: parsed, ignored here
    raster_prefix: str = "matmul"
    raster_packed: bool = True
    raster_expander: str = "pallas"
    raster_alpha_matmul: bool = False
    tight_rect: bool = True
    presize_instances: bool = True
    presize_factor: float = 3.0
    overflow_check_every: int = 25
    max_screen_size: int = 20
    inv_lr_clip: float = 0.0
    scale_floor: float = 0.0
    prune_min_scale: float = 0.0
    seed: int = 666
    data_workers: int = 4
    mesh_data: int = 1
    mesh_tile: int = 1
    save_iterations: List[int] = dataclasses.field(default_factory=list)
    testing_iterations: List[int] = dataclasses.field(default_factory=list)
    use_wandb: bool = False
    wandb_project: str = "saro-gs-tpu"
    profile_dir: str = ""
    profile_iters: tuple = (100, 110)
    nan_check: bool = False

    unknown_keys: dict = dataclasses.field(default_factory=dict)

    # ---- derived static configs ----
    def field_config(self) -> FieldConfig:
        kc = self.kplanes_config
        return FieldConfig(resolution=tuple(kc["resolution"]),
                           out_dim=int(kc["output_coordinate_dim"]),
                           multires=tuple(self.multires))

    def model_config(self) -> ModelConfig:
        return ModelConfig(
            sh_degree=self.sh_degree,
            deform_hidden_dim=self.deform_hidden_dim,
            deform_time_encode=self.deform_time_encode,
            dx=self.dx, drot=self.drot, dopacity=self.dopacity,
            dsh=self.dsh, sigmoid_tcenter=self.sigmoid_tcenter,
            min_intergral=self.min_intergral,
            integral_renorm=self.integral_renorm,
            min_interval=self.min_interval,
            scale_reg=self.scale_reg, shs_reg=self.shs_reg,
            motion_reg=self.motion_reg, field=self.field_config())

    def loss_weights(self) -> LossWeights:
        return LossWeights(
            lambda_dssim=self.lambda_dssim,
            lambda_dtstd=self.lambda_dtstd,
            lambda_dscale_reg=self.lambda_dscale_reg,
            lambda_dshs_reg=self.lambda_dshs_reg,
            lambda_dmotion_reg=self.lambda_dmotion_reg,
            lambda_dplanetv=self.lambda_dplanetv,
            lambda_dtime_smooth=self.lambda_dtime_smooth)

    def raster_config(self) -> RasterConfig:
        # the same tiling the JAX package picks for this config, so the two
        # packages bin (and count n_contrib) alike
        if self.raster_backend == "pallas":
            t = self.tile_size
            return RasterConfig(tile_x=t, tile_y=t, chunk=self.chunk,
                                max_instances=self.max_instances,
                                tight_rect=self.tight_rect)
        return RasterConfig(tile_x=16, tile_y=16, chunk=64,
                            max_instances=self.max_instances,
                            tight_rect=self.tight_rect)


def load_config(json_path: Optional[str] = None, **overrides) -> Config:
    """Defaults <- per-scene JSON <- keyword overrides."""
    cfg = Config()
    known = {f.name for f in dataclasses.fields(Config)}
    values = {}
    if json_path:
        with open(json_path) as f:
            values.update(json.load(f))
    values.update(overrides)
    unknown = {}
    for k, v in values.items():
        if k in known:
            setattr(cfg, k, v)
        else:
            unknown[k] = v
    cfg.unknown_keys = unknown
    return cfg


def load_cfg_args(path: str) -> Config:
    with open(path) as f:
        d = json.load(f)
    d.pop("unknown_keys", None)
    return load_config(**d)
