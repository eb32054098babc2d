"""Vanilla-NeRF trainer (port of ``nerf_projects_tpu/train/nerf_trainer.py``).

Reference nerf/nerf.ipynb cell 19: one Adam optimizer over the coarse and
fine models at lrate 5e-4, loss = MSE(fine) + MSE(coarse), the learning
rate decaying as 0.1^(step / (lrate_decay * 1000)), PSNR from the fine
MSE.

The MLP runs through one of three routes:
- the modules in ``compute_dtype``, differentiated by autograd;
- with ``use_fused_mlp`` (depth 8, width 256, viewdirs, multires 10/4),
  the fused MLP (``ops/kernels/fused_mlp.py``): its forward kernel and,
  under autograd, its weight-gradient kernel;
- with ``use_mega`` as well (and no sigma noise), the fused train level
  (``ops/kernels/fused_train.py``): one kernel per hierarchy level runs
  the MLP forward, the compositing, the MSE gradient and the MLP
  backward, and autograd is not used.
On the CPU each kernel is replaced by its plain PyTorch version.

Data parallelism (``mesh=``, a ``parallel/mesh.py::make_mesh`` mesh whose
"rays" axis has W ranks): ``train_step`` takes this rank's contiguous
shard of the global ray batch; every rank draws the randoms of the global
batch and keeps its rows (``ops/sampling.py::global_draw``), so the split
changes where the work runs and not what is drawn; each route forms its
loss as this rank's sum of squared errors over the global count (the
fused train level gets the global ray count, ``n_rays_total``), so the
ranks' gradients add up to the global batch's; the gradients and the
loss sums go into one float32 buffer and one ``all_reduce`` sums it, and
Adam then takes the same step on every rank, whose replicas stay equal
bit for bit. JAX's mesh routes (``shard_map`` around the fused MLP and a
``psum`` of the fused level's gradients, its nerf_trainer.py:87-118 and
:202-245) compute the same sums.

``render_step`` is the deterministic serving path over one ray batch and
``render_image`` chunks an image's rays through it; both evaluate the
modules, as the reference does, unless ``use_kernel`` asks for the fused
MLP. ``train_step`` is one
Adam step; ``scan_steps`` runs many, drawing ray batches on the device
from a pool, with no host round trip per step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.models.nerf import NeRFMLP
from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig, render_rays
from nerf_projects_tpu_torch.obs.trace import span
from nerf_projects_tpu_torch.ops.kernels.fused_mlp import fused_apply, unpack_grads
from nerf_projects_tpu_torch.ops.kernels.fused_train import pack_level_inputs_raw, train_level
from nerf_projects_tpu_torch.ops.posenc import posenc_dim
from nerf_projects_tpu_torch.ops.sampling import (
    cast_rays,
    merge_sorted,
    piecewise_constant_pdf,
    stratified_sample,
)
from nerf_projects_tpu_torch.parallel.mesh import RAY_AXIS, axis_info
from nerf_projects_tpu_torch.train.schedules import exponential_decay

Params = Tuple[NeRFMLP, Optional[NeRFMLP]]
Grads = Tuple[dict, Optional[dict]]  # per model: parameter name -> gradient


@dataclass
class TrainState:
    """What a training run carries from step to step. ``train_step``
    updates it in place (the models, the optimizer's moments, the
    generator) and returns it."""

    step: int
    params: Params
    optimizer: torch.optim.Optimizer
    generator: torch.Generator

    @property
    def models(self) -> Params:  # what a checkpoint holds (train/checkpoint.py)
        return self.params


def _module_apply(model: NeRFMLP, pts_enc, views_enc=None):
    return model(pts_enc, views_enc)


class NeRFTrainer:
    """Owns the model and optimizer definitions and the train and render
    steps."""

    def __init__(
        self,
        cfg: NeRFRenderConfig,
        *,
        depth: int = 8,
        width: int = 256,
        lrate: float = 5e-4,
        lrate_decay: float = 250,
        near: float = 2.0,
        far: float = 6.0,
        compute_dtype: torch.dtype = torch.float32,
        separate_fine: bool = True,
        use_fused_mlp: bool = False,
        use_mega: bool = False,
        mega_rc: int = 8,
        mega_rf: int = 4,
        mesh=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.cfg = cfg
        self.near = near
        self.far = far
        self.lrate = lrate
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
        # The fused train level replaces autograd; the architecture gate
        # of the fused MLP, plus no sigma noise (the loss gradient is made
        # in the kernel).
        self.use_mega = bool(
            use_mega
            and depth == 8
            and width == 256
            and cfg.use_viewdirs
            and cfg.multires == 10
            and cfg.multires_views == 4
            and cfg.raw_noise_std == 0.0
        )
        # rays per block of the per-ray inputs, coarse and fine level
        self.mega_rc = mega_rc
        self.mega_rf = mega_rf
        self.schedule = exponential_decay(lrate, lrate_decay)
        # data parallelism over the mesh's "rays" axis (module docstring)
        self.mesh = mesh
        if mesh is not None:
            self.rank, self.world, self.group = axis_info(mesh, RAY_AXIS)

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

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int) -> TrainState:
        """Models from ``seed`` (``init_params``), a fresh Adam (b1 0.9,
        b2 0.999, eps 1e-7) over all their parameters, and a generator on
        the trainer's device seeded with ``seed``."""
        params = self.init_params(seed)
        optimizer = torch.optim.Adam(
            [p for m in params if m is not None for p in m.parameters()],
            lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-7,
        )
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(step=0, params=params, optimizer=optimizer, generator=generator)

    # -- steps ------------------------------------------------------------

    @property
    def apply_fn(self):
        return fused_apply if self.use_fused_mlp else _module_apply

    def _shard_rows(self, n_local: int):
        """This rank's (start, stop, n_total) of the global batch, the
        shards being equal; None without a mesh."""
        if self.mesh is None:
            return None
        return (self.rank * n_local, (self.rank + 1) * n_local, self.world * n_local)

    @staticmethod
    def _mse(rgb: torch.Tensor, target: torch.Tensor, rows) -> torch.Tensor:
        """The MSE, or on a shard (``rows``) its share of the global batch's:
        the shard's sum of squared errors over the global count."""
        if rows is None:
            return torch.mean((rgb - target) ** 2)
        return torch.sum((rgb - target) ** 2) / (rows[2] * target.shape[-1])

    def loss_fn(self, params: Params, generator: torch.Generator, rays: Rays, target: torch.Tensor, rows=None):
        """(MSE(fine) + MSE(coarse), MSE(fine)) of a randomized render; on a
        shard (``rows``) the shard's shares of them (``_mse``)."""
        out = render_rays(
            generator, params[0], params[1], self.apply_fn, rays, self.near, self.far, self.cfg,
            randomized=True, rows=rows,
        )
        loss = self._mse(out["rgb"], target, rows)
        psnr_mse = loss
        if "rgb0" in out:
            loss = loss + self._mse(out["rgb0"], target, rows)
        return loss, psnr_mse

    def _mega_value_and_grad(self, params: Params, generator: torch.Generator, rays: Rays,
                             target: torch.Tensor, rows=None):
        """The value and gradients through the fused train level: sampling
        and raw input packing in torch, then one kernel per level, which
        encodes the points itself (weights in the block layout, as the
        reference trainer's mega_raw). The random draws come in
        render_rays' order (stratified depths, then the pdf uniforms), so
        both routes see the same samples from one generator state. On a
        shard (``rows``) the kernels get the global ray count, so the
        gradients are the shard's share of the global batch's."""
        cfg = self.cfg
        n_rays = rays.origins.shape[0]
        n_total = n_rays if rows is None else rows[2]
        bkgd = 1.0 if cfg.white_bkgd else 0.0
        Sc = cfg.num_coarse_samples
        z_vals = stratified_sample(
            generator, Sc, self.near, self.far, (n_rays,), lindisp=cfg.lindisp,
            randomized=cfg.perturb, device=rays.origins.device, rows=rows,
        )
        pts = cast_rays(z_vals, rays.origins, rays.directions)
        x, vt = pack_level_inputs_raw(pts, rays.viewdirs, z_vals, rays.directions, target, Sc, self.mega_rc)
        rgb0, _, w0, gc = train_level(
            params[0], x, vt, S=Sc, R=self.mega_rc, n_rays_total=n_total, bkgd=bkgd,
            want_weights=cfg.num_fine_samples > 0, raw_inputs=True,
        )
        mse0 = self._mse(rgb0, target, rows)
        grads_c = unpack_grads(gc, params[0], raw_layout=True)
        if cfg.num_fine_samples == 0:
            return (mse0, mse0), (grads_c, None)

        z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = piecewise_constant_pdf(
            generator, z_mids, w0[..., 1:-1], cfg.num_fine_samples, randomized=cfg.perturb,
            mode=cfg.pdf_mode, sorted_u=cfg.resample_sorted, rows=rows,
        )
        if cfg.resample_sorted:
            z_comb = merge_sorted(z_vals, z_samples)
        else:
            z_comb = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
        pts_f = cast_rays(z_comb, rays.origins, rays.directions)
        Sf = Sc + cfg.num_fine_samples
        pf = params[1] if params[1] is not None else params[0]
        xf, vtf = pack_level_inputs_raw(pts_f, rays.viewdirs, z_comb, rays.directions, target, Sf, self.mega_rf)
        rgb, _, _, gf = train_level(
            pf, xf, vtf, S=Sf, R=self.mega_rf, n_rays_total=n_total, bkgd=bkgd,
            want_weights=False, raw_inputs=True,
        )
        mse = self._mse(rgb, target, rows)
        grads_f = unpack_grads(gf, pf, raw_layout=True)
        if params[1] is None:
            grads = ({k: grads_c[k] + grads_f[k] for k in grads_c}, None)
        else:
            grads = (grads_c, grads_f)
        return (mse + mse0, mse), grads

    def _value_and_grad(self, params: Params, generator: torch.Generator, rays: Rays,
                        target: torch.Tensor):
        """((loss, psnr_mse), grads): grads per model, by parameter name.
        Under a mesh ``rays`` and ``target`` are this rank's shard and the
        results those of the global batch (``_all_reduce``)."""
        rows = self._shard_rows(rays.origins.shape[0])
        if self.use_mega:
            out = self._mega_value_and_grad(params, generator, rays, target, rows)
        else:
            models = [m for m in params if m is not None]
            named = [(i, n, p) for i, m in enumerate(models) for n, p in m.named_parameters()]
            loss, psnr_mse = self.loss_fn(params, generator, rays, target, rows)
            flat = torch.autograd.grad(loss, [p for _, _, p in named])
            grads = [{} for _ in models]
            for (i, n, _), g in zip(named, flat):
                grads[i][n] = g
            out = (loss.detach(), psnr_mse.detach()), (grads[0], grads[1] if len(grads) > 1 else None)
        return out if rows is None else self._all_reduce(*out)

    def _all_reduce(self, stats, grads: Grads):
        """The ranks' shares summed: the gradients and the two loss sums in
        one float32 buffer, one ``all_reduce(SUM)`` over the "rays" axis,
        then views of it in their shapes."""
        leaves = [g for model in grads if model is not None for g in model.values()]
        buf = torch.cat([t.reshape(-1).float() for t in leaves] + [s.reshape(1).float() for s in stats])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        at, summed = 0, []
        for model in grads:
            if model is None:
                summed.append(None)
                continue
            views = {}
            for name, g in model.items():
                views[name] = buf[at: at + g.numel()].view(g.shape)
                at += g.numel()
            summed.append(views)
        return (buf[at], buf[at + 1]), tuple(summed)

    def train_step(self, state: TrainState, rays: Rays, target: torch.Tensor):
        """One Adam step on a [R] ray batch (under a mesh, this rank's shard
        of the global batch; the stats are the global batch's); the
        learning rate of update k (k = 0, 1, ...) is schedule(k), as optax
        evaluates it. Returns (state, {"loss", "psnr"}) with the stats as
        device tensors."""
        with span("nerf.step"):
            (loss, psnr_mse), grads = self._value_and_grad(state.params, state.generator, rays, target)
            self.apply_grads(state, grads)
            psnr = -10.0 * torch.log(psnr_mse) / math.log(10.0)
            return state, {"loss": loss, "psnr": psnr}

    def apply_grads(self, state: TrainState, grads: Grads) -> TrainState:
        """One Adam update of the models with ``grads`` at the learning
        rate schedule(state.step), then state.step += 1."""
        for model, g in zip(state.params, grads):
            if model is not None:
                for name, p in model.named_parameters():
                    p.grad = g[name]
        lr = float(self.schedule(state.step))
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state

    def scan_steps(self, state: TrainState, pool_rays: Rays, pool_rgb: torch.Tensor, n_steps: int,
                   batch_size: int = 1024):
        """Run n_steps train steps, each on a batch of ``batch_size`` rays
        drawn with replacement from the pool on its device. Under a mesh
        every rank holds the whole pool and draws the same global indices
        (its generator seeded as the others'), then trains on its shard of
        them. Returns (state, {"loss", "psnr"} of [n_steps] device
        tensors)."""
        n_pool = pool_rgb.shape[0]
        if self.mesh is not None and batch_size % self.world:
            raise ValueError(f"batch_size {batch_size} does not split over {self.world} ranks")
        losses, psnrs = [], []
        for _ in range(n_steps):
            idx = torch.randint(0, n_pool, (batch_size,), generator=state.generator,
                                device=pool_rgb.device)
            if self.mesh is not None:
                per = batch_size // self.world
                idx = idx[self.rank * per:(self.rank + 1) * per]
            rays = pool_rays.map(lambda x: x[idx])
            state, stats = self.train_step(state, rays, pool_rgb[idx])
            losses.append(stats["loss"])
            psnrs.append(stats["psnr"])
        return state, {"loss": torch.stack(losses), "psnr": torch.stack(psnrs)}

    @torch.no_grad()
    def render_step(self, params: Params, rays: Rays, use_kernel: bool = False):
        """Deterministic (serving) render of a [R] ray batch. By default
        the modules run in ``compute_dtype``, as the reference's
        render_step does whatever the training route; ``use_kernel``
        serves through the fused MLP (bf16 products) instead and needs
        ``use_fused_mlp``."""
        if use_kernel and not self.use_fused_mlp:
            raise ValueError("use_kernel needs a trainer whose use_fused_mlp gate passed")
        coarse, fine = params
        return render_rays(
            None, coarse, fine, fused_apply if use_kernel else _module_apply, rays, self.near,
            self.far, self.cfg, randomized=False,
        )

    @torch.no_grad()
    def render_image(self, params: Params, rays: Rays, chunk: int = 16384, use_kernel: bool = False):
        """Render rays of any batch shape in chunks of ``chunk`` rays
        through ``render_step`` (``use_kernel`` as there); the last chunk
        is padded by repeating its last ray and cut back."""
        with span("view"):
            shape = rays.batch_shape
            flat = rays.map(lambda t: t.reshape(-1, 3))
            n = flat.origins.shape[0]
            outs = []
            for i in range(0, n, chunk):
                sl = flat.map(lambda t: t[i : i + chunk])
                pad = chunk - sl.origins.shape[0]
                if pad:
                    sl = sl.map(lambda t: F.pad(t[None], (0, 0, 0, pad), mode="replicate")[0])
                out = self.render_step(params, sl, use_kernel)
                if pad:
                    out = {k: v[: chunk - pad] for k, v in out.items()}
                outs.append(out)
            merged = {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
            return {k: v.reshape(tuple(shape) + v.shape[1:]) for k, v in merged.items()}
