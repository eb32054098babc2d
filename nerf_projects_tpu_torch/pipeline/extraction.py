"""NeRF -> PlenOctree extraction (port of
``nerf_projects_tpu/pipeline/extraction.py``).

Parity target: reference plenoctree/octree/extraction.py:
  * ``auto_scale`` (:251-293): the box shrunk to the cells of a
    2^init_grid_depth grid whose sigma passes the alpha threshold;
  * ``extract_octree``: step 1 (:295-362), sigma at the 2^(d+1)^3 cell
    centres, masked by the sigma threshold -log(1 - alpha_thresh) / (2 /
    reso) or by the largest ray weight over the training cameras
    (``grid_weight_render``), then d rounds of refining the leaves that
    hold masked cells; step 2 (:364-403), ``samples_per_cell`` random
    points in each finest leaf, whose mean [SH coefficients, sigma] it
    stores (NeRF-SH), or the alpha-weighted rgb mean and the mean sigma
    (a projected vanilla NeRF, ``rgba_mode``); then sigma relu'd
    (:576-577);
  * ``make_sh_projection_eval_fn`` (:224-248): the Monte-Carlo SH
    projection of a view-dependent NeRF.

An ``eval_fn(points [C, 3]) -> (coefficients [C, D - 1], sigma [C, 1])``
takes and returns tensors on the extraction's device; it runs under
``torch.inference_mode()``. Each phase keeps its sigma on the device and
reads it back once; the cell centres are formed on the device from the
float32 per-axis arrays the JAX package's ``_cell_center_grid`` meshes,
and step 2's offsets are drawn from ``np.random.default_rng(seed)`` as
there, so both packages sample the same points. ``grid_weight_render``
also serves the Plenoxels grid lifecycle's weight-threshold resample.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import camera_rays
from nerf_projects_tpu_torch.models.octree import PlenOctree, refine_at_points
from nerf_projects_tpu_torch.ops.sh import project_function_sh, spherical_uniform_dirs


def _axis_centres(reso: int, invradius, offset) -> list:
    """Per axis, the world float32 coordinates of the reso cell centres
    (``_cell_center_grid``'s, extraction.py:301-310)."""
    arr = (np.arange(reso, dtype=np.float32) + 0.5) / reso
    return [(arr - offset[a]) / invradius[a] for a in range(3)]


def _f32_threshold(t: float) -> float:
    """The least float32 >= t: a float32 x >= it exactly where x >= t in
    float64, as numpy compares float32 sigmas with a float64 threshold."""
    f = np.float32(t)
    return float(np.nextafter(f, np.float32(np.inf)) if f < t else f)


def _centres(axes, reso: int, idx: torch.Tensor) -> torch.Tensor:
    """World points [n, 3] of the flat C-order cell indices idx [n]."""
    return torch.stack([axes[0][idx // (reso * reso)], axes[1][(idx // reso) % reso], axes[2][idx % reso]], -1)


def sigma_grid(eval_fn: Callable, reso: int, invradius, offset, chunk: int, device) -> Tuple[torch.Tensor, list]:
    """(sigma [reso^3] at the cell centres, C order, on ``device``; the
    per-axis centre arrays there), the model evaluated ``chunk`` points at
    a time."""
    axes = [torch.from_numpy(a).to(device) for a in _axis_centres(reso, invradius, offset)]
    n = reso ** 3
    sigma = torch.empty(n, dtype=torch.float32, device=device)
    with torch.inference_mode():
        for i in range(0, n, chunk):
            idx = torch.arange(i, min(i + chunk, n), device=device)
            sigma[i:i + chunk] = eval_fn(_centres(axes, reso, idx))[1][:, 0]
    return sigma, axes


def auto_scale(
    eval_fn: Callable,
    center,
    radius,
    *,
    init_grid_depth: int = 8,
    scale_alpha_thresh: float = 0.01,
    chunk: int = 65536,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[list, list]:
    """(center, radius) shrunk to the box of the cells whose sigma passes
    the alpha threshold (extraction.py:251), on ``device`` (None: the
    card); unchanged when no cell does."""
    dev = resolve_device(device)
    reso = 2**init_grid_depth
    radius = np.broadcast_to(np.asarray(radius, np.float32), (3,))
    center = np.asarray(center, np.float32)
    invradius = 0.5 / radius
    offset = 0.5 * (1.0 - center / radius)
    sigmas, axes = sigma_grid(eval_fn, reso, invradius, offset, chunk, dev)
    sigma_thresh = -np.log(1.0 - scale_alpha_thresh) / (2.0 / reso)
    sel = torch.nonzero(sigmas >= _f32_threshold(sigma_thresh))[:, 0]
    if sel.numel() == 0:
        return center.tolist(), radius.tolist()
    # the axes' centres rise with the index: the box's corners are the
    # centres at the smallest and largest selected index on each axis
    ijk = (sel // (reso * reso), (sel // reso) % reso, sel % reso)
    lo = np.array([float(a[i.min()]) for a, i in zip(axes, ijk)], np.float32)
    hi = np.array([float(a[i.max()]) for a, i in zip(axes, ijk)], np.float32)
    lc = lo - 0.5 / reso
    uc = hi + 0.5 / reso
    return ((lc + uc) * 0.5).tolist(), ((uc - lc) * 0.5).tolist()


def grid_weight_render(
    sigmas: np.ndarray,
    c2w: np.ndarray,
    intrinsics: np.ndarray,
    height: int,
    width: int,
    *,
    step_size: float = 1e-3,
    ray_subsample: int = 1,
    slice_steps: int = 64,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """The largest ray weight each cell of a dense [reso]^3 sigma grid
    receives from one camera (svox's ``_C.grid_weight_render``,
    misc_kernel.cu:310-334; extraction.py:212): camera rays marched in the
    unit cube (world [-1, 1] -> [0, 1); callers move other frames there)
    with nearest-cell lookups, transmittance weights, and a scatter-max
    into the visited cells. ``slice_steps`` steps of every ray at a time
    (the transmittance carried across slices); on ``device`` (None: the
    card). Returns float32 [reso]^3 on the host."""
    dev = resolve_device(device)
    reso = sigmas.shape[0]
    sig = torch.as_tensor(np.ascontiguousarray(sigmas, np.float32), device=dev).reshape(-1)
    rays = camera_rays(height // ray_subsample, width // ray_subsample, np.asarray(intrinsics) / ray_subsample,
                       np.asarray(c2w), device=dev)
    origins = rays.origins.reshape(-1, 3)
    dirs = rays.directions.reshape(-1, 3)

    o = origins * 0.5 + 0.5
    d = dirs * 0.5
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    t_lo = (0.0 - o) * inv_d
    t_hi = (1.0 - o) * inv_d
    t0 = torch.clamp(torch.amax(torch.minimum(t_lo, t_hi), -1), min=0.0)
    t1 = torch.amin(torch.maximum(t_lo, t_hi), -1)
    world_len = torch.linalg.norm(dirs, dim=-1)
    dt = step_size / torch.clamp(torch.linalg.norm(d, dim=-1), min=1e-12)
    step_world = dt * world_len

    max_steps = int(np.ceil(np.sqrt(3.0) / step_size)) + 1
    log_T = torch.zeros(o.shape[0], device=dev)
    max_w = torch.zeros(reso**3, device=dev)
    for k0 in range(0, max_steps, slice_steps):
        idx = torch.arange(k0, min(k0 + slice_steps, max_steps), dtype=torch.float32, device=dev)
        t = t0[:, None] + idx[None, :] * dt[:, None]  # [N, S]
        valid = t < t1[:, None]
        pos = o[:, None, :] + t[..., None] * d[:, None, :]
        cell = torch.clamp((pos * reso).to(torch.int32), 0, reso - 1).long()
        flat = (cell[..., 0] * reso + cell[..., 1]) * reso + cell[..., 2]
        tau = torch.where(valid, sig[flat], 0.0) * step_world[:, None]
        before = log_T[:, None] - (torch.cumsum(tau, dim=-1) - tau)  # log T at each sample
        w = torch.exp(before) * (1.0 - torch.exp(-tau))
        max_w.scatter_reduce_(0, flat.reshape(-1), torch.where(valid, w, 0.0).reshape(-1), reduce="amax")
        log_T = before[:, -1] - tau[:, -1]
    return max_w.reshape(reso, reso, reso).cpu().numpy()


def _mean_over_samples(x: torch.Tensor) -> torch.Tensor:
    """x [n, S, C] -> the mean over S, summed in sample order (numpy's
    float32 order for a middle axis), then divided by S."""
    out = x[:, 0]
    for k in range(1, x.shape[1]):
        out = out + x[:, k]
    return out / x.shape[1]


def extract_octree(
    eval_fn: Callable,
    *,
    center=(0.0, 0.0, 0.0),
    radius=1.5,
    data_dim: int,
    init_grid_depth: int = 8,
    alpha_thresh: float = 0.01,
    samples_per_cell: int = 8,
    masking_mode: str = "sigma",
    weight_thresh: float = 1e-4,
    dataset=None,
    renderer_step_size: float = 1e-3,
    chunk: int = 65536,
    seed: int = 0,
    rgba_mode: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    stats: Optional[dict] = None,
) -> PlenOctree:
    """Build a PlenOctree from a field-evaluation function on ``device``
    (None: the card): ``eval_fn(points [C, 3]) -> (coefficients [C,
    data_dim - 1], sigma [C, 1])``, the model's ``eval_points_raw``.
    ``stats``, when given, receives the step-1 mask's share of the cells
    and the number of finest leaves."""
    dev = resolve_device(device)
    tree = PlenOctree.create(data_dim, center=center, radius=radius, depth_limit=init_grid_depth + 2, device=dev)

    # ---- step 1: grid eval + masking + refine ---------------------------
    reso = 2 ** (init_grid_depth + 1)
    sigmas, axes = sigma_grid(eval_fn, reso, tree.invradius, tree.offset, chunk, dev)
    approx_delta = 2.0 / reso
    sigma_thresh = -np.log(1.0 - alpha_thresh) / approx_delta
    if masking_mode == "sigma":
        mask = sigmas >= _f32_threshold(sigma_thresh)
    elif masking_mode == "weight":
        if dataset is None:
            raise ValueError("weight masking needs a dataset")
        grid_sig = sigmas.reshape(reso, reso, reso).cpu().numpy()
        max_weight = np.zeros_like(grid_sig)
        for v in range(dataset.poses.shape[0]):
            w = grid_weight_render(grid_sig, dataset.poses[v], dataset.intrinsics, dataset.height, dataset.width,
                                   step_size=renderer_step_size, ray_subsample=4, device=dev)
            max_weight = np.maximum(max_weight, w)
        mask = torch.from_numpy(max_weight.reshape(-1) >= weight_thresh).to(dev)
    else:
        raise ValueError(masking_mode)
    del sigmas
    idx = torch.nonzero(mask)[:, 0]
    if stats is not None:
        stats["masked_share"] = idx.numel() / reso**3
    if idx.numel() == 0:
        return tree
    tree = refine_at_points(tree, _centres(axes, reso, idx), init_grid_depth)
    del idx

    # ---- step 2: per-leaf sampling + averaging --------------------------
    flat, depths, corners, sizes = tree.leaf_geometry()
    finest = depths == depths.max()
    flat = torch.from_numpy(flat[finest]).to(dev)
    sel_corners = torch.from_numpy(corners[finest]).to(dev)  # float64, as the JAX package's numpy
    sel_sizes = torch.from_numpy(sizes[finest]).to(dev)
    offset64 = torch.from_numpy(tree.offset.astype(np.float64)).to(dev)
    inv64 = torch.from_numpy(tree.invradius.astype(np.float64)).to(dev)
    n_leaf = flat.numel()
    if stats is not None:
        stats["finest_leaves"] = n_leaf

    rng = np.random.default_rng(seed)
    S = samples_per_cell
    data = tree.data.reshape(-1, data_dim)
    eval_chunk = max(1, chunk // S)
    with torch.inference_mode():
        for i in range(0, n_leaf, eval_chunk):
            c = slice(i, min(i + eval_chunk, n_leaf))
            nc = c.stop - c.start
            offs = torch.from_numpy(rng.random((nc, S, 3)).astype(np.float32)).to(dev)
            unit = sel_corners[c][:, None, :] + offs.double() * sel_sizes[c][:, None, None]
            world = ((unit - offset64) / inv64).float().reshape(-1, 3)
            coeffs, sigma = eval_fn(world)
            coeffs = coeffs.reshape(nc, S, -1)
            sigma = sigma.reshape(nc, S, 1)
            if rgba_mode:
                # alpha-weighted rgb average (extraction.py:389-399)
                alpha = 1.0 - torch.exp(-approx_delta * sigma)
                msum = alpha.sum(1)
                rgb_avg = (coeffs * alpha).sum(1) / torch.clamp(msum, min=1e-12)
                rgb_avg = torch.where(msum < 1e-3, 0.0, rgb_avg)
                rgba = torch.cat([rgb_avg, _mean_over_samples(sigma)], -1)
            else:
                rgba = _mean_over_samples(torch.cat([coeffs, sigma], -1))
            data[flat[c]] = rgba
        # sigma relu (extraction.py:576-577)
        data[:, -1] = torch.relu(data[:, -1])
    return tree


def make_sh_projection_eval_fn(
    model_eval_cross: Callable,
    sh_deg: int,
    *,
    projection_samples: int = 100,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable:
    """Wrap a vanilla (view-dependent) NeRF into an SH-coefficient
    eval_fn: ``model_eval_cross(points [N, 3], dirs [D, 3]) -> (rgb [N, D,
    3], sigma [N, 1])`` (the cross-broadcast eval of
    octree/nerf/model_utils.py:87-159), projected per extraction.py:224-248
    onto ``projection_samples`` directions drawn from ``seed`` on
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    dirs = spherical_uniform_dirs(projection_samples, torch.Generator(device=dev).manual_seed(seed), dev)

    def eval_fn(points):
        rgb, sigma = model_eval_cross(points, dirs)
        coeffs = project_function_sh(rgb, dirs, sh_deg)  # [N, 3, B]
        return coeffs.reshape(points.shape[0], -1), sigma

    return eval_fn
