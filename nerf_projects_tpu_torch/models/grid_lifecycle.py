"""SparseGrid topology lifecycle: upsampling, dilation and empty-space
distances (port of ``nerf_projects_tpu/models/grid_lifecycle.py``).

Parity targets (reference svox2/svox2/svox2.py):
  * ``resample`` (:1223-1424): progressive upsampling: density and SH
    trilinearly resampled at the new resolution's cell positions, a mask
    by sigma threshold or by the largest ray weight over the training
    cameras (``pipeline/extraction.py::grid_weight_render``) with an
    optional top-k ``max_elements`` bound, 3D dilation (x2 by default),
    then the links rebuilt (z-order) over the kept cells;
  * ``dilate_mask`` (csrc/misc_kernel.cu:21): 26-neighbourhood dilation;
  * ``compute_skip_grid`` (:1487-1494, accel_dist_prop): the L-inf
    distance to the nearest occupied cell;
  * ``resize`` (:1451-1486): the SH basis dimension changed in place.

These are host-staged events between training epochs, as the reference
schedules them (opt.py:855-887): the masks and links are numpy and scipy
(on both machines); the resampling runs on the grid's device.
``sparsify_background`` prunes a background MSI's texels (svox2.py:1426-1449).
``to_octree`` exports the grid to a PlenOctree (svox2's ``to_svox1``) and
``octree_to_grid`` bakes a tree into a grid at its finest resolution,
both on the device of their input.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid, _grid_transform, morton_code_3d
from nerf_projects_tpu_torch.ops.grid import trilerp


def dilate_mask(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """26-neighbourhood binary dilation (misc_kernel.cu:21)."""
    from scipy import ndimage

    if iterations <= 0:
        return mask
    return ndimage.binary_dilation(mask, structure=np.ones((3, 3, 3), bool), iterations=iterations)


def compute_skip_grid(links: np.ndarray) -> np.ndarray:
    """Chebyshev (L-inf) distance to the nearest occupied cell, int32 [X,
    Y, Z]: 0 at occupied cells (accel_dist_prop)."""
    from scipy import ndimage

    occupied = np.asarray(links) >= 0
    if occupied.all():
        return np.zeros(links.shape, np.int32)
    if not occupied.any():
        return np.full(links.shape, max(links.shape), np.int32)
    return ndimage.distance_transform_cdt(~occupied, metric="chessboard").astype(np.int32)


def _occupancy_from_weights(grid: SparseGrid, density: np.ndarray, new_reso, cameras, *, weight_thresh: float,
                            step_size: float = 1e-3, ray_subsample: int = 4, max_elements: int = 0) -> np.ndarray:
    """The largest ray weight over the training cameras, thresholded
    (resample's weight path, svox2.py:1319-1358). Each camera pose is
    moved into the grid's unit-cube frame first."""
    from nerf_projects_tpu_torch.pipeline.extraction import grid_weight_render

    reso = tuple(new_reso)
    sig = np.maximum(density.reshape(reso), 0.0)
    max_w = np.zeros(reso, np.float32)
    for pose, K, h, w in cameras:
        pose = np.asarray(pose, np.float64).copy()
        pose[:3, 3] = (pose[:3, 3] - grid.center) / grid.radius
        w_img = grid_weight_render(sig, pose.astype(np.float32), K, h, w, step_size=step_size,
                                   ray_subsample=ray_subsample, device=grid.device)
        max_w = np.maximum(max_w, w_img)
    if max_elements > 0 and (max_w >= weight_thresh).sum() > max_elements:
        thresh = np.partition(max_w.ravel(), -max_elements)[-max_elements]  # the top-k bound
        return max_w >= max(thresh, weight_thresh)
    return max_w >= weight_thresh


def resample(
    grid: SparseGrid,
    new_reso,
    *,
    sigma_thresh: float = 5.0,
    weight_thresh: float = 0.01,
    dilate: int = 2,
    cameras: Optional[Sequence] = None,
    use_z_order: bool = True,
    max_elements: int = 0,
    batch_size: int = 262144,
) -> SparseGrid:
    """The grid rebuilt at ``new_reso`` over its occupied cells, on its
    device. ``cameras``: [(c2w, K, height, width), ...] for the
    largest-ray-weight mask; else the sigma threshold."""
    if isinstance(new_reso, int):
        new_reso = (new_reso, new_reso, new_reso)
    new_reso = tuple(int(r) for r in new_reso)
    dev = grid.device
    X, Y, Z = new_reso
    n = X * Y * Z
    # the new grid's cell positions in world space, then in the old grid
    scale, offset, radius, center = _grid_transform(new_reso, grid.radius, grid.center, dev)
    density_new = torch.empty((n, 1), dtype=torch.float32, device=dev)
    sh_new = torch.empty((n, grid.sh_data.shape[1]), dtype=torch.float32, device=dev)
    for i in range(0, n, batch_size):
        idx = torch.arange(i, min(i + batch_size, n), device=dev)
        g = torch.stack([idx // (Y * Z), (idx // Z) % Y, idx % Z], dim=-1).float()
        gpts = grid.world_to_grid((g - offset) / scale * radius + center)
        density_new[i:i + batch_size] = trilerp(grid, grid.density_data, gpts)
        sh_new[i:i + batch_size] = trilerp(grid, grid.sh_data, gpts)

    dens_host = density_new[:, 0].cpu().numpy()
    if cameras is not None:
        mask = _occupancy_from_weights(grid, dens_host, new_reso, cameras, weight_thresh=weight_thresh,
                                       max_elements=max_elements)
    else:
        mask = (dens_host >= sigma_thresh).reshape(new_reso)
    mask = dilate_mask(mask, dilate)
    if not mask.any():
        # a degenerate threshold: keep the densest cell so the grid stays
        # renderable (the reference would fail downstream instead)
        mask = mask.reshape(-1)
        mask[np.argmax(dens_host)] = True
        mask = mask.reshape(new_reso)

    n_active = int(mask.sum())
    links = np.full(new_reso, -1, np.int32)
    act = np.argwhere(mask)
    if n_active and use_z_order:
        act = act[np.argsort(morton_code_3d(act[:, 0], act[:, 1], act[:, 2]))]
    links[act[:, 0], act[:, 1], act[:, 2]] = np.arange(n_active, dtype=np.int32)
    flat_idx = torch.from_numpy((act[:, 0] * Y + act[:, 1]) * Z + act[:, 2]).to(dev)
    return SparseGrid(
        links=torch.from_numpy(links).to(dev),
        density_data=density_new[flat_idx],
        sh_data=sh_new[flat_idx],
        radius=grid.radius.copy(),
        center=grid.center.copy(),
        basis_dim=grid.basis_dim,
    )


def resize(grid: SparseGrid, basis_dim: int) -> SparseGrid:
    """The SH basis dimension changed (svox2.py:1451-1486): per colour the
    min(old, new) low-order coefficients kept, added ones zero. The
    caller resets its optimizer state (the reference clears sh_rms)."""
    if int(np.sqrt(basis_dim)) ** 2 != basis_dim:
        raise ValueError("basis_dim (SH) must be a square number")
    if not (1 <= basis_dim <= 25):
        raise ValueError("basis_dim 1-25 supported")
    old = grid.basis_dim
    if basis_dim == old:
        return grid
    sh = grid.sh_data.reshape(grid.capacity, 3, old)
    keep = min(old, basis_dim)
    new_sh = torch.zeros((grid.capacity, 3, basis_dim), dtype=grid.sh_data.dtype, device=grid.device)
    new_sh[:, :, :keep] = sh[:, :, :keep]
    return dataclasses.replace(grid, sh_data=new_sh.reshape(grid.capacity, 3 * basis_dim), basis_dim=basis_dim)


def to_octree(grid: SparseGrid, *, depth: Optional[int] = None, sigma_thresh: float = 0.0):
    """Export the grid to a PlenOctree (svox2 ``to_svox1``, svox2.py:1630)
    on the grid's device: a tree whose finest leaves align with the
    occupied cells (density >= ``sigma_thresh`` when it is > 0), filled by
    sampling the grid at those leaves' centres."""
    from nerf_projects_tpu_torch.models.octree import PlenOctree, refine_at_points
    from nerf_projects_tpu_torch.ops.grid import sample_grid

    reso = grid.reso
    if depth is None:
        depth = int(np.ceil(np.log2(max(reso)))) - 1
    dev = grid.device
    tree = PlenOctree.create(3 * grid.basis_dim + 1, center=tuple(grid.center.tolist()),
                             radius=tuple(grid.radius.tolist()), depth_limit=depth + 2, device=dev)
    links = grid.links.reshape(-1)
    occ = links >= 0
    if sigma_thresh > 0:
        dens = grid.density_data[torch.clamp(links, min=0).long(), 0]
        occ = occ & (dens >= sigma_thresh)
    X, Y, Z = reso
    act = torch.nonzero(occ)[:, 0]
    if act.numel() == 0:
        return tree
    act = torch.stack([act // (Y * Z), (act // Z) % Y, act % Z], dim=-1)
    # the cell centres in the unit cube, then in the world, in float64 (the
    # JAX package's numpy), handed to the descent as float32
    unit = (act.double() + 0.5) / torch.tensor(reso, dtype=torch.float64, device=dev)
    world = ((unit - torch.from_numpy(tree.offset.astype(np.float64)).to(dev))
             / torch.from_numpy(tree.invradius.astype(np.float64)).to(dev)).float()
    tree = refine_at_points(tree, world, depth)
    return _fill_finest(tree, lambda pts: _grid_payload(grid, pts, sample_grid))


def _grid_payload(grid: SparseGrid, pts: torch.Tensor, sample_grid) -> torch.Tensor:
    density, sh = sample_grid(grid, pts)
    return torch.cat([sh, torch.relu(density)], dim=-1)


def _leaf_centres_world(tree, corners: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """World float32 [L, 3] of the leaves' centres (float64 on the host, as
    the JAX package computes them)."""
    centres = corners + sizes[:, None] * 0.5
    return ((centres - tree.offset) / tree.invradius).astype(np.float32)


def _fill_finest(tree, payload_fn, batch: int = 262144):
    """The tree with its finest leaves' data set to ``payload_fn`` (world
    points [B, 3] on the tree's device -> [B, D]) at their centres."""
    flat, depths, corners, sizes = tree.leaf_geometry()
    finest = depths == depths.max()
    world = _leaf_centres_world(tree, corners[finest], sizes[finest])
    flat = torch.from_numpy(flat[finest]).to(tree.device)
    data = tree.data.reshape(-1, tree.data_dim).clone()
    for i in range(0, len(world), batch):
        pts = torch.from_numpy(world[i:i + batch]).to(tree.device)
        data[flat[i:i + batch]] = payload_fn(pts)
    return tree.replace(data=data.reshape(tree.data.shape))


def _axis_centres(reso: int, tree) -> list:
    """Per axis, the world float32 coordinates of the reso cell centres:
    ((i + 0.5) / reso - offset) / invradius in float64, as the JAX
    package's meshgrid computes them."""
    unit = (np.arange(reso) + 0.5) / reso
    return [((unit - tree.offset[a]) / tree.invradius[a]).astype(np.float32) for a in range(3)]


def octree_to_grid(tree, *, reso: Optional[int] = None, sigma_thresh: float = 0.0, dilate: int = 1,
                   batch: int = 262144) -> SparseGrid:
    """Bake a PlenOctree into a SparseGrid at its finest resolution on the
    tree's device: the tree queried at the cell centres, cells with relu'd
    sigma > ``sigma_thresh`` kept, the mask dilated by ``dilate`` cells
    (26-neighbourhood: a rim that keeps boundary trilerps' colours, as
    resample dilates, svox2.py:1360), links in C order over the kept cells.
    The JAX package's result, without its dense [reso^3, D] host array:
    sigma first (reso^3 floats on the device), then the mask, its dilation
    and the links, last the values of the kept cells only."""
    if reso is None:
        reso = int(2 ** tree.max_depth())
    basis_dim = (tree.data_dim - 1) // 3
    dev = tree.device
    radius = (0.5 / tree.invradius).astype(np.float32)
    center = ((0.5 - tree.offset) / tree.invradius).astype(np.float32)
    axes = [torch.from_numpy(a).to(dev) for a in _axis_centres(reso, tree)]
    n = reso ** 3

    def points(idx):  # flat C-order cell indices -> world points
        return torch.stack([axes[0][idx // (reso * reso)], axes[1][(idx // reso) % reso], axes[2][idx % reso]], -1)

    sigma = torch.empty(n, dtype=torch.float32, device=dev)
    for i in range(0, n, batch):
        idx = torch.arange(i, min(i + batch, n), device=dev)
        sigma[i:i + batch] = torch.relu(tree.query(points(idx), column=tree.data_dim - 1))
    mask = sigma > sigma_thresh
    if dilate > 0:
        # 26-neighbourhood dilation (dilate_mask's) as a 3^3 max filter
        m = mask.reshape(1, 1, reso, reso, reso).to(torch.float16)
        for _ in range(dilate):
            m = torch.nn.functional.max_pool3d(m, 3, stride=1, padding=1)
        mask = m.reshape(-1) > 0
    act = torch.nonzero(mask)[:, 0]
    if act.numel() == 0:
        act = torch.argmax(sigma).reshape(1)
    links = torch.full((n,), -1, dtype=torch.int32, device=dev)
    links[act] = torch.arange(act.numel(), dtype=torch.int32, device=dev)
    sh = torch.empty((act.numel(), 3 * basis_dim), dtype=torch.float32, device=dev)
    for i in range(0, act.numel(), batch):
        sh[i:i + batch] = tree.query(points(act[i:i + batch]))[:, : 3 * basis_dim]
    return SparseGrid(links=links.reshape(reso, reso, reso), density_data=sigma[act][:, None], sh_data=sh,
                      radius=radius, center=center, basis_dim=basis_dim)


def sparsify_background(msi, sigma_thresh: float = 1.0, dilate: int = 1):
    """Zero the background MSI's texels whose density is below
    ``sigma_thresh`` after the keep mask is dilated (26-neighbourhood in
    (layer, v, u), as the reference's _C.dilate): the reference's
    ``sparsify_background`` (svox2.py:1426-1449), called after an upsample
    (opt.py:876-880). The reference drops pruned texels from its compact
    arrays; the MSI is dense, so they become zeros, which render as
    empty. On the host (scipy), returned on the MSI's device."""
    from scipy import ndimage

    from nerf_projects_tpu_torch.ops.background import BackgroundMSI

    data = msi.data.detach().cpu().numpy()  # [L, H, W, 4]
    keep = data[..., 3] >= sigma_thresh
    if dilate > 0:
        keep = ndimage.binary_dilation(keep, structure=np.ones((3, 3, 3), bool), iterations=int(dilate))
    data = np.where(keep[..., None], data, 0.0).astype(np.float32)
    return BackgroundMSI(data=torch.from_numpy(data).to(msi.data.device), radii=msi.radii)
