"""NeRF-SH trainer (port of ``nerf_projects_tpu/train/nerf_sh_trainer.py``).

Reference plenoctree/nerf_sh/train.py:61-131 (`train_step`):
  loss = MSE(fine) + MSE(coarse) + sparsity + weight_decay_mult * weight_l2
  * sparsity: sigma at uniform random points in the cube of radius
    ``sparsity_radius``, loss = w * (1 - mean(exp(-length * relu(sigma))));
  * weight_l2 = sum(p^2) / #params over all parameters (SG lobes included);
  * Adam (b1 0.9, b2 0.999, eps 1e-8) at the jaxnerf log-linear learning
    rate of its update count.

The model runs its modules, or with ``use_fused_trunk`` (SH and SG
heads at full width) the fused trunk kernels under autograd. The state
is the model itself, a ``torch.optim.Adam`` whose learning rate is set
each step, and a generator on the trainer's device that draws the
stratified depths, the sigma noise, the pdf uniforms and the sparsity
points.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.models.nerf_sh import NeRFSHModel
from nerf_projects_tpu_torch.train.schedules import log_linear_decay


@dataclass
class SHTrainState:
    """What a training run carries from step to step. ``train_step``
    updates it in place (the model, Adam's moments, the generator) and
    returns it."""

    step: int
    model: NeRFSHModel
    optimizer: torch.optim.Optimizer
    generator: torch.Generator

    @property
    def models(self) -> tuple:  # what a checkpoint holds (train/checkpoint.py)
        return (self.model,)


def _psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


class NeRFSHTrainer:
    """Owns the model definition, the schedule and the loss; ``init_state``
    makes the parameters."""

    def __init__(
        self,
        model: NeRFSHModel,
        *,
        lr_init: float = 5e-4,
        lr_final: float = 5e-6,
        max_steps: int = 1_000_000,
        lr_delay_steps: int = 2500,
        lr_delay_mult: float = 0.01,
        sparsity_weight: float = 0.0,
        sparsity_length: float = 0.05,
        sparsity_npoints: int = 10000,
        sparsity_radius: float = 1.5,
        weight_decay_mult: float = 0.0,
        randomized: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.model = model
        self.sparsity_weight = sparsity_weight
        self.sparsity_length = sparsity_length
        self.sparsity_npoints = sparsity_npoints
        self.sparsity_radius = sparsity_radius
        self.weight_decay_mult = weight_decay_mult
        self.randomized = randomized
        self.device = resolve_device(device)
        self.schedule = log_linear_decay(
            lr_init, lr_final, max_steps, lr_delay_steps=lr_delay_steps, lr_delay_mult=lr_delay_mult,
        )

    def init_state(self, seed: int) -> SHTrainState:
        """A copy of the model initialised on the host from ``seed`` (the
        same weights on every device), then moved; a fresh Adam over all
        its parameters; a generator on the trainer's device seeded with
        ``seed``."""
        model = copy.deepcopy(self.model).reset_parameters(torch.Generator().manual_seed(seed))
        model = model.to(self.device)
        optimizer = torch.optim.Adam(model.parameters(), lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return SHTrainState(step=0, model=model, optimizer=optimizer, generator=generator)

    def loss_fn(self, model: NeRFSHModel, generator: Optional[torch.Generator], rays: Rays,
                pixels: torch.Tensor, sparsity_points: Optional[torch.Tensor] = None):
        """(total loss, stats). The sparsity points come from ``generator``
        unless given ([sparsity_npoints, 3])."""
        ret = model(rays, self.randomized, generator)
        loss = torch.mean((ret[-1].rgb - pixels[..., :3]) ** 2)
        stats = {"loss": loss, "psnr": _psnr(loss)}
        total = loss
        if len(ret) > 1:
            loss_c = torch.mean((ret[0].rgb - pixels[..., :3]) ** 2)
            stats["loss_c"] = loss_c
            stats["psnr_c"] = _psnr(loss_c)
            total = total + loss_c
        if self.sparsity_weight > 0:
            pts = sparsity_points
            if pts is None:
                r = self.sparsity_radius
                u = torch.rand((self.sparsity_npoints, 3), generator=generator, device=pixels.device)
                pts = u * (2.0 * r) - r
            _, sp_sigma = model.eval_points_raw(pts)
            loss_sp = self.sparsity_weight * (
                1.0 - torch.mean(torch.exp(-self.sparsity_length * F.relu(sp_sigma))))
            stats["loss_sp"] = loss_sp
            total = total + loss_sp
        if self.weight_decay_mult > 0:
            params = list(model.parameters())
            weight_l2 = sum(torch.sum(p ** 2) for p in params) / sum(p.numel() for p in params)
            stats["weight_l2"] = weight_l2
            total = total + self.weight_decay_mult * weight_l2
        return total, stats

    def value_and_grad(self, model: NeRFSHModel, generator: Optional[torch.Generator], rays: Rays,
                       pixels: torch.Tensor, **kwargs):
        """(stats, gradients by parameter name) of ``loss_fn``; a parameter
        the loss does not reach gets a zero gradient, as under jax.grad."""
        total, stats = self.loss_fn(model, generator, rays, pixels, **kwargs)
        named = list(model.named_parameters())
        flat = torch.autograd.grad(total, [p for _, p in named], allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, flat)}
        return {k: v.detach() for k, v in stats.items()}, grads

    def train_step(self, state: SHTrainState, rays: Rays, pixels: torch.Tensor, **kwargs):
        """One Adam step on a [R] ray batch; update k (k = 0, 1, ...) runs
        at schedule(k), as optax evaluates it. Returns (state, stats) with
        the stats as device tensors."""
        stats, grads = self.value_and_grad(state.model, state.generator, rays, pixels, **kwargs)
        for name, p in state.model.named_parameters():
            p.grad = grads[name]
        lr = float(self.schedule(state.step))
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, stats

    @torch.no_grad()
    def render_eval(self, model: NeRFSHModel, rays: Rays) -> dict:
        """Deterministic render of a [R] ray batch: the fine level's rgb,
        disp and acc."""
        fine = model(rays, False)[-1]
        return {"rgb": fine.rgb, "disp": fine.disp, "acc": fine.acc}
