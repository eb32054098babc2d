"""NeRF-SH flag set (port of ``nerf_projects_tpu/cli/nerf_sh_flags.py``):
a dataclass mirror of the reference's absl flags
(plenoctree/nerf_sh/nerf/utils.py:61-230 ``define_flags``), and
``build_model``, the ``construct_nerf`` equivalent. The port adds
``use_fused_trunk`` (default off, as the reference builds the model) to
run a full-width SH or SG trunk through the fused kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class NeRFSHFlags:
    # paths
    train_dir: Optional[str] = None
    data_dir: Optional[str] = None
    config: Optional[str] = None
    # dataset
    dataset: str = "blender"
    image_batching: bool = False
    white_bkgd: bool = True
    batch_size: int = 1024
    factor: int = 4
    spherify: bool = False
    render_path: bool = False
    llffhold: int = 8
    # model
    model: str = "nerf"
    near: float = 2.0
    far: float = 6.0
    net_depth: int = 8
    net_width: int = 256
    net_depth_condition: int = 1
    net_width_condition: int = 128
    weight_decay_mult: float = 0.0
    skip_layer: int = 4
    num_rgb_channels: int = 3
    num_sigma_channels: int = 1
    randomized: bool = True
    min_deg_point: int = 0
    max_deg_point: int = 10
    deg_view: int = 4
    num_coarse_samples: int = 64
    num_fine_samples: int = 128
    use_viewdirs: bool = True
    sh_deg: int = -1
    sg_dim: int = -1
    noise_std: Optional[float] = None
    lindisp: bool = False
    net_activation: str = "relu"
    rgb_activation: str = "sigmoid"
    sigma_activation: str = "relu"
    legacy_posenc_order: bool = False
    use_fused_trunk: bool = False
    # train
    lr_init: float = 5e-4
    lr_final: float = 5e-6
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 0.01
    max_steps: int = 1_000_000
    save_every: int = 10000
    print_every: int = 1000
    render_every: int = 5000
    gc_every: int = 5000
    sparsity_weight: float = 0.0
    sparsity_length: float = 0.05
    sparsity_radius: float = 1.5
    sparsity_npoints: int = 10000
    # profiling
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    # eval
    eval_once: bool = True
    save_output: bool = True
    chunk: int = 8192
    approx_eval_skip: int = 1


def build_model(flags: NeRFSHFlags):
    """``construct_nerf`` (models.py:351-428): activations looked up and
    validated, then the model built from the flags."""
    from nerf_projects_tpu_torch.models.nerf_sh import ACTIVATIONS, NeRFSHModel, validate_activations

    rgb_act = ACTIVATIONS[flags.rgb_activation]
    sigma_act = ACTIVATIONS[flags.sigma_activation]
    validate_activations(rgb_act, sigma_act)
    return NeRFSHModel(
        num_coarse_samples=flags.num_coarse_samples,
        num_fine_samples=flags.num_fine_samples,
        use_viewdirs=flags.use_viewdirs,
        sh_deg=flags.sh_deg,
        sg_dim=flags.sg_dim,
        near=flags.near,
        far=flags.far,
        noise_std=flags.noise_std,
        net_depth=flags.net_depth,
        net_width=flags.net_width,
        net_depth_condition=flags.net_depth_condition,
        net_width_condition=flags.net_width_condition,
        skip_layer=flags.skip_layer,
        num_sigma_channels=flags.num_sigma_channels,
        white_bkgd=flags.white_bkgd,
        min_deg_point=flags.min_deg_point,
        max_deg_point=flags.max_deg_point,
        deg_view=flags.deg_view,
        lindisp=flags.lindisp,
        rgb_activation=rgb_act,
        sigma_activation=sigma_act,
        net_activation=ACTIVATIONS[flags.net_activation],
        use_fused_trunk=flags.use_fused_trunk,
    )
