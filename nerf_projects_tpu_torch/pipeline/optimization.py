"""PlenOctree finetuning on training images (port of
``nerf_projects_tpu/pipeline/optimization.py``).

Parity target: reference plenoctree/octree/optimization.py:141-394: SGD
(lr ~1e7) or Adam over the tree's leaf data, full-image MSE a step
through the octree renderer, validation every ``val_interval`` epochs,
the best tree kept and the run stopped early when the val PSNR drops.

``OctreeFinetuner`` differentiates the exact octree march
(``ops/octree_render.py``) by autograd. ``finetune_fast`` bakes the tree
into a grid and trains that through the march kernels (K3 + K4,
``PlenoxelsTrainer.train_step_tiles_pallas``), then writes the grid back
into the leaves.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerf_projects_tpu_torch.core.rays import Rays, camera_rays, ndc_rays
from nerf_projects_tpu_torch.models.octree import PlenOctree
from nerf_projects_tpu_torch.obs.metrics import mse2psnr
from nerf_projects_tpu_torch.ops.octree_render import OctreeRenderOptions, volume_render_octree


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [m, ...] padded to n rows with copies of its last row (the JAX
    package's edge padding of a short last chunk)."""
    pad = n - x.shape[0]
    return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])]) if pad else x


class OctreeFinetuner:
    def __init__(
        self,
        opts: OctreeRenderOptions = OctreeRenderOptions(),
        *,
        optimizer: str = "sgd",
        lr: float = 1e7,
        chunk: int = 8192,
        ndc: "tuple | None" = None,
    ):
        """``ndc=(height, width, focal)`` warps rays into OpenGL NDC before
        the octree traversal (viewdirs stay world-space for the SH
        decode), so the octree is read over the NDC cube: the svox
        ``NDCConfig`` the reference passes for LLFF scenes
        (plenoctree/octree/optimization.py:188-192). The tree's device is
        where the finetuning runs."""
        if optimizer not in ("sgd", "adam"):
            raise ValueError(optimizer)
        self.opts = opts
        self.optimizer = optimizer
        self.lr = lr
        self.chunk = chunk
        self.ndc = ndc

    def init_state(self, tree: PlenOctree):
        """The optimizer's state: None for SGD, (m, v, t) for Adam."""
        if self.optimizer == "adam":
            return torch.zeros_like(tree.data), torch.zeros_like(tree.data), 0
        return None

    def step(self, tree: PlenOctree, data: torch.Tensor, state, rays: Rays, target: torch.Tensor):
        """One update of the leaf data on a chunk of rays: (data, state,
        mse), JAX's update formulas (Adam with b1 0.9, b2 0.999, eps 1e-8)."""
        data = data.detach().requires_grad_(True)
        out = volume_render_octree(tree.replace(data=data), rays, self.opts)
        mse = torch.mean((out["rgb"] - target) ** 2)
        (g,) = torch.autograd.grad(mse, data)
        with torch.no_grad():
            if self.optimizer == "sgd":
                return data - self.lr * g, state, mse.detach()
            m, v, t = state
            t = t + 1
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mhat = m / (1 - 0.9**t)
            vhat = v / (1 - 0.999**t)
            return data - self.lr * mhat / (torch.sqrt(vhat) + 1e-8), (m, v, t), mse.detach()

    def _image_rays(self, ds, idx, device) -> Rays:
        rays = camera_rays(ds.height, ds.width, ds.intrinsics, ds.poses[idx], device=device)
        flat = rays.map(lambda x: x.reshape(-1, 3))
        if self.ndc is not None:
            h, w, focal = self.ndc
            o, d = ndc_rays(h, w, focal, 1.0, flat.origins, flat.directions)
            flat = Rays(o, d, flat.viewdirs)
        return flat

    def eval_psnr(self, tree: PlenOctree, ds, indices=None) -> float:
        indices = range(ds.images.shape[0]) if indices is None else indices
        psnrs = []
        with torch.inference_mode():
            for v in indices:
                flat = self._image_rays(ds, v, tree.device)
                n = flat.origins.shape[0]
                img = torch.cat([volume_render_octree(tree, flat.map(lambda x: x[i:i + self.chunk]), self.opts)["rgb"]
                                 for i in range(0, n, self.chunk)])
                target = torch.as_tensor(np.asarray(ds.images[v]).reshape(-1, 3), device=tree.device)
                psnrs.append(float(mse2psnr(torch.mean((img - target) ** 2))))
        return float(np.mean(psnrs))

    def finetune(
        self,
        tree: PlenOctree,
        train_ds,
        val_ds=None,
        *,
        n_epochs: int = 10,
        val_interval: int = 2,
        early_stop: bool = True,
        verbose: bool = False,
    ) -> PlenOctree:
        """Returns the best tree (by val PSNR when val_ds is given)."""
        data = tree.data
        state = self.init_state(tree)
        best_data = data
        best_psnr = -np.inf
        for epoch in range(n_epochs):
            for v in range(train_ds.images.shape[0]):
                flat = self._image_rays(train_ds, v, tree.device)
                target_full = torch.as_tensor(np.asarray(train_ds.images[v]).reshape(-1, 3), device=tree.device)
                n = flat.origins.shape[0]
                for i in range(0, n, self.chunk):
                    sl = flat.map(lambda x: _pad_rows(x[i:i + self.chunk], self.chunk))
                    tgt = _pad_rows(target_full[i:i + self.chunk], self.chunk)
                    data, state, _ = self.step(tree, data, state, sl, tgt)
            if val_ds is not None and (epoch + 1) % val_interval == 0:
                cur = self.eval_psnr(tree.replace(data=data), val_ds)
                if verbose:
                    print(f"epoch {epoch}: val psnr {cur:.2f}")
                if cur > best_psnr:
                    best_psnr = cur
                    best_data = data
                elif early_stop:
                    break
        if val_ds is None:
            best_data = data
        return tree.replace(data=best_data)


def _image_tiles(ds, v: int, tile_h: int, tile_w: int, device):
    """A view's rays as [T, tile_h * tile_w] tiles and its pixels [T,
    tile_h * tile_w, 3]."""
    from nerf_projects_tpu_torch.ops.tile_render import tiles_from_image_rays

    H, W = int(ds.height), int(ds.width)
    rays = camera_rays(H, W, ds.intrinsics, ds.poses[v], device=device)
    tiles = tiles_from_image_rays(rays.map(lambda x: x.reshape(-1, 3)), H, W, tile_h, tile_w)
    tgt = torch.as_tensor(np.asarray(ds.images[v]), device=device).reshape(H // tile_h, tile_h, W // tile_w, tile_w, 3)
    return tiles, tgt.permute(0, 2, 1, 3, 4).reshape(-1, tile_h * tile_w, 3)


def grid_psnr(bg, ds, opts, *, tiles_per_batch: int = 40, tile_h: int = 8, tile_w: int = 16) -> float:
    """Mean PSNR over ``ds``'s views of a BrickGrid rendered by the march
    (K3 on the card), in batches of tiles."""
    from nerf_projects_tpu_torch.ops.kernels.tile_march import render_tiles_pallas
    from nerf_projects_tpu_torch.ops.tile_render import untile_image

    H, W = int(ds.height), int(ds.width)
    psnrs = []
    with torch.inference_mode():
        for v in range(ds.images.shape[0]):
            tiles, _ = _image_tiles(ds, v, tile_h, tile_w, bg.device)
            outs = [render_tiles_pallas(bg, tiles.map(lambda x: x[i:i + tiles_per_batch]), opts)["rgb"]
                    for i in range(0, tiles.origins.shape[0], tiles_per_batch)]
            img = untile_image(torch.cat(outs), H, W, tile_h, tile_w)
            target = torch.as_tensor(np.asarray(ds.images[v]), device=bg.device)
            psnrs.append(float(mse2psnr(torch.mean((img - target) ** 2))))
    return float(np.mean(psnrs))


def write_back(tree: PlenOctree, grid, batch: int = 262144) -> PlenOctree:
    """The tree with every leaf's data set to the SparseGrid sampled at
    the leaf's centre (the inverse of the bake): [SH..., density]."""
    from nerf_projects_tpu_torch.models.grid_lifecycle import _leaf_centres_world
    from nerf_projects_tpu_torch.ops.grid import sample_grid

    flat, _, corners, sizes = tree.leaf_geometry()
    world = _leaf_centres_world(tree, corners, sizes)
    flat = torch.from_numpy(flat).to(tree.device)
    data = tree.data.detach().reshape(-1, tree.data_dim).clone()
    with torch.inference_mode():
        for i in range(0, len(world), batch):
            density, sh = sample_grid(grid, torch.from_numpy(world[i:i + batch]).to(tree.device))
            data[flat[i:i + batch]] = torch.cat([sh, density], -1)
    return tree.replace(data=data.reshape(tree.data.shape))


def finetune_fast(
    tree: PlenOctree,
    train_ds,
    val_ds=None,
    *,
    n_epochs: int = 10,
    val_interval: int = 2,
    early_stop: bool = True,
    tiles_per_batch: int = 40,
    tile_h: int = 8,
    tile_w: int = 16,
    step_size: float = 0.5,
    color_mode: str = "sigmoid",
    lr_sigma: float = 3e1,
    lr_sh: float = 1e-2,
    sigma_thresh: float = 0.0,
    seed: int = 0,
    verbose: bool = False,
    stats: Optional[dict] = None,
) -> PlenOctree:
    """Octree finetuning through the march kernels, on the tree's device:

      1. the tree baked into a BrickGrid at its finest resolution
         (``octree_to_grid``, the fast evaluator's bake);
      2. the grid trained by ``PlenoxelsTrainer.train_step_tiles_pallas``
         (K3 + K4 and RMSprop, no TV), every training view as coherent
         tiles each epoch, views in ``np.random.default_rng(seed +
         epoch)`` order, a short last batch padded with its last tile;
      3. the grid written back into the leaves, sampled at each leaf's
         centre (``write_back``), the topology kept;
      4. the best grid by val PSNR kept, with the reference's stop on a
         drop.
    ``stats``, when given, receives the baked grid's val PSNR before
    training (``initial_val_psnr``) and each validation's
    (``val_psnr``)."""
    from nerf_projects_tpu_torch.models.grid_lifecycle import octree_to_grid
    from nerf_projects_tpu_torch.ops.brick_grid import from_sparse_grid, to_sparse_grid
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
    from nerf_projects_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainer

    H, W = int(train_ds.height), int(train_ds.width)
    n_views = train_ds.images.shape[0]
    tiles_per_image = (H // tile_h) * (W // tile_w)
    steps_per_epoch = max(n_views * tiles_per_image // tiles_per_batch, 1)
    dev = tree.device

    bg = from_sparse_grid(octree_to_grid(tree, sigma_thresh=sigma_thresh))
    # color_mode must match the tree's decode (PlenOctree = sigmoid,
    # svox2-exported trees = bias) or training optimizes the wrong image
    opts = GridRenderOptions(step_size=step_size, color_mode=color_mode)
    trainer = PlenoxelsTrainer(opts, n_iters=max(n_epochs * steps_per_epoch, 1), lr_sigma=lr_sigma,
                               lr_sigma_delay_steps=0, lr_sh=lr_sh, lambda_tv=0.0, lambda_tv_sh=0.0, device=dev)
    rms = trainer.init_rms_bricks(bg)
    generator = torch.Generator(device=dev).manual_seed(seed)  # draws nothing: no TV
    if stats is not None:
        stats["initial_val_psnr"] = grid_psnr(bg, val_ds, opts, tiles_per_batch=tiles_per_batch, tile_h=tile_h,
                                              tile_w=tile_w) if val_ds is not None else None
        stats["val_psnr"] = []

    best_bg, best_psnr = bg, -np.inf
    step_i = 0
    for epoch in range(n_epochs):
        for v in np.random.default_rng(seed + epoch).permutation(n_views):
            tiles, tgt = _image_tiles(train_ds, int(v), tile_h, tile_w, dev)
            for i in range(0, tiles.origins.shape[0], tiles_per_batch):
                sl = tiles.map(lambda x: _pad_rows(x[i:i + tiles_per_batch], tiles_per_batch))
                t_sl = _pad_rows(tgt[i:i + tiles_per_batch], tiles_per_batch)
                bg, rms, _ = trainer.train_step_tiles_pallas(bg, rms, sl, t_sl, float(step_i), generator)
                step_i += 1
        if val_ds is not None and (epoch + 1) % val_interval == 0:
            cur = grid_psnr(bg, val_ds, opts, tiles_per_batch=tiles_per_batch, tile_h=tile_h, tile_w=tile_w)
            if stats is not None:
                stats["val_psnr"].append(cur)
            if verbose:
                print(f"finetune_fast epoch {epoch}: val psnr {cur:.2f}")
            if cur > best_psnr:
                best_psnr = cur
                best_bg = bg
            elif early_stop:
                break
    if val_ds is None:
        best_bg = bg
    return write_back(tree, to_sparse_grid(best_bg))
