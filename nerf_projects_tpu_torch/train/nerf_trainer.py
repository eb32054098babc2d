"""Vanilla-NeRF trainer, render half (port of
``nerf_projects_tpu/train/nerf_trainer.py``).

Builds the coarse and fine ``NeRFMLP``s from a seed and renders with
them: ``render_step`` is the deterministic serving path over one ray
batch, ``render_image`` chunks an image's rays through it. When
``use_fused_mlp`` holds (depth 8, width 256, viewdirs, multires 10/4),
both levels run through the fused-MLP kernel
(``ops/kernels/fused_mlp.py``), in bf16 products with float32
accumulation, over a weight buffer built once per model and kept on it;
otherwise through the modules in ``compute_dtype``.
Training (Adam, the fused train-step kernel) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.models.nerf import NeRFMLP
from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig, render_rays
from nerf_projects_tpu_torch.ops.kernels.fused_mlp import fused_apply
from nerf_projects_tpu_torch.ops.posenc import posenc_dim

Params = Tuple[NeRFMLP, Optional[NeRFMLP]]


def _module_apply(model: NeRFMLP, pts_enc, views_enc=None):
    return model(pts_enc, views_enc)


class NeRFTrainer:
    """Owns the model definitions and the render steps."""

    def __init__(
        self,
        cfg: NeRFRenderConfig,
        *,
        depth: int = 8,
        width: int = 256,
        near: float = 2.0,
        far: float = 6.0,
        compute_dtype: torch.dtype = torch.float32,
        separate_fine: bool = True,
        use_fused_mlp: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.cfg = cfg
        self.near = near
        self.far = far
        self.device = resolve_device(device)
        self.depth = depth
        self.width = width
        self.compute_dtype = compute_dtype
        # The fused kernel covers exactly the flagship architecture.
        self.use_fused_mlp = bool(
            use_fused_mlp
            and depth == 8
            and width == 256
            and cfg.use_viewdirs
            and cfg.multires == 10
            and cfg.multires_views == 4
        )
        self.separate_fine = separate_fine and cfg.num_fine_samples > 0

    def make_model(self) -> NeRFMLP:
        return NeRFMLP(
            depth=self.depth,
            width=self.width,
            use_viewdirs=self.cfg.use_viewdirs,
            in_ch=posenc_dim(3, self.cfg.multires),
            in_ch_views=posenc_dim(3, self.cfg.multires_views),
            compute_dtype=self.compute_dtype,
        )

    def init_params(self, seed: int) -> Params:
        """Coarse and fine (or None) models, initialised on the host from
        ``seed`` (the same weights on every device), then moved."""
        gen = torch.Generator().manual_seed(seed)
        coarse = self.make_model().reset_parameters(gen).to(self.device)
        fine = (
            self.make_model().reset_parameters(gen).to(self.device)
            if self.separate_fine
            else None
        )
        return coarse, fine

    @torch.no_grad()
    def render_step(self, params: Params, rays: Rays):
        """Deterministic (serving) render of a [R] ray batch."""
        coarse, fine = params
        apply_fn = fused_apply if self.use_fused_mlp else _module_apply
        return render_rays(
            None, coarse, fine, apply_fn, rays, self.near, self.far, self.cfg,
            randomized=False,
        )

    @torch.no_grad()
    def render_image(self, params: Params, rays: Rays, chunk: int = 16384):
        """Render rays of any batch shape in chunks of ``chunk`` rays; the
        last chunk is padded by repeating its last ray and cut back."""
        shape = rays.batch_shape
        flat = rays.map(lambda t: t.reshape(-1, 3))
        n = flat.origins.shape[0]
        outs = []
        for i in range(0, n, chunk):
            sl = flat.map(lambda t: t[i : i + chunk])
            pad = chunk - sl.origins.shape[0]
            if pad:
                sl = sl.map(lambda t: F.pad(t[None], (0, 0, 0, pad), mode="replicate")[0])
            out = self.render_step(params, sl)
            if pad:
                out = {k: v[: chunk - pad] for k, v in out.items()}
            outs.append(out)
        merged = {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
        return {k: v.reshape(tuple(shape) + v.shape[1:]) for k, v in merged.items()}
