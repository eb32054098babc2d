"""Floater visualization (port of ``nerf_projects_tpu/obs/floater_viz.py``).

Parity target: reference svox2/opt/util/floater_visualization.py —
visualize FDR floater detections as density-slice images with floater
voxels highlighted, plus a per-component summary panel. Renders headless
PNGs (usable standalone or logged to TensorBoard as images).

The masks and projections are numpy on the host (a grid on the card is
read back once); the voxels' world positions come from the grid's own
``grid_to_world``. ``scipy`` and ``matplotlib`` are imported at the call:
the masks and projections need only scipy, the figures matplotlib.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _world(grid, coords: np.ndarray) -> np.ndarray:
    """World positions [n, 3] of voxel coordinates through the grid's
    ``grid_to_world`` (float32, on the grid's device), as numpy."""
    g = torch.as_tensor(np.asarray(coords, np.float32), device=grid.device)
    return _host(grid.grid_to_world(g))


def floater_masks(grid, *, threshold: float = 0.01, min_object_size: int = 1000,
                  connectivity: int = 26, return_labels: bool = False):
    """Dense (occupancy, floater_mask) volumes from a SparseGrid.

    With return_labels=True also returns (labels, main_label, sizes) —
    the connected-component decomposition the per-component overlays
    color by (reference create_multi_object_voxel_overlay:290)."""
    from scipy import ndimage

    from nerf_projects_tpu_torch.obs.advanced_metrics import _occupancy_from_grid

    occ = _occupancy_from_grid(grid, threshold, True)
    struct = ndimage.generate_binary_structure(3, {6: 1, 18: 2, 26: 3}[connectivity])
    labels, n = ndimage.label(occ, structure=struct)
    sizes = np.bincount(labels.ravel())
    sizes[0] = 0
    if n == 0:
        if return_labels:
            return occ, np.zeros_like(occ), labels, 0, sizes
        return occ, np.zeros_like(occ)
    order = np.argsort(sizes)[::-1]
    main_label = order[0]
    floater_labels = [
        l for l in range(1, n + 1)
        if l != main_label and sizes[l] < max(min_object_size, sizes[main_label])
    ]
    floater = np.isin(labels, floater_labels)
    if return_labels:
        return occ, floater, labels, int(main_label), sizes
    return occ, floater


def render_floater_slices(
    grid,
    out_dir: str,
    *,
    threshold: float = 0.01,
    min_object_size: int = 100,
    n_slices: int = 4,
    axis: int = 2,
):
    """Write axis-aligned density slices with floaters highlighted red.

    Returns the list of written PNG paths.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    occ, floater = floater_masks(
        grid, threshold=threshold, min_object_size=min_object_size
    )
    os.makedirs(out_dir, exist_ok=True)
    reso = occ.shape[axis]
    paths = []
    for i, frac in enumerate(np.linspace(0.2, 0.8, n_slices)):
        idx = int(frac * (reso - 1))
        sl = [slice(None)] * 3
        sl[axis] = idx
        occ_sl = occ[tuple(sl)]
        flo_sl = floater[tuple(sl)]
        img = np.zeros(occ_sl.shape + (3,))
        img[occ_sl] = [0.7, 0.7, 0.7]
        img[flo_sl] = [1.0, 0.1, 0.1]
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(img, origin="lower")
        ax.set_title(f"axis {axis} slice {idx} — floaters red")
        ax.axis("off")
        p = os.path.join(out_dir, f"floater_slice_{axis}_{idx:04d}.png")
        fig.savefig(p, bbox_inches="tight")
        plt.close(fig)
        paths.append(p)
    return paths


def project_floaters_to_view(
    grid,
    floater_mask: np.ndarray,
    pose: np.ndarray,
    intrinsics: np.ndarray,
    height: int,
    width: int,
    *,
    min_density: float = 0.1,
):
    """2D heatmap of floater voxels projected into a camera
    (floater_visualization.py:59 project_floaters_to_view; density
    filtering reproduced, occlusion filtering left to the overlay's
    alpha since our renders already carry the geometry).

    pose: OpenCV-convention c2w [4,4]; intrinsics [3,3]. Returns
    [H, W] float heatmap (None if no visible floaters).
    """
    coords = np.argwhere(floater_mask)
    if len(coords) == 0:
        return None
    links = _host(grid.links)
    rows = links[coords[:, 0], coords[:, 1], coords[:, 2]]
    dens = np.zeros(len(coords))
    ok = rows >= 0
    dens[ok] = _host(grid.density_data)[rows[ok], 0]
    keep = dens >= min_density
    coords = coords[keep]
    if len(coords) == 0:
        return None

    world = _world(grid, coords)
    w2c = np.linalg.inv(np.asarray(pose, np.float64))
    cam = world @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    front = z > 1e-6
    cam = cam[front]
    if len(cam) == 0:
        return None
    px = intrinsics[0, 0] * cam[:, 0] / cam[:, 2] + intrinsics[0, 2]
    py = intrinsics[1, 1] * cam[:, 1] / cam[:, 2] + intrinsics[1, 2]
    inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    if not inside.any():
        return None
    heat, _, _ = np.histogram2d(
        py[inside], px[inside],
        bins=[height, width], range=[[0, height], [0, width]],
    )
    return heat


def overlay_on_render(rgb: np.ndarray, heatmap: np.ndarray,
                      alpha: float = 0.9) -> np.ndarray:
    """Red floater overlay on a rendered image
    (create_floater_overlay_on_render)."""
    out = np.asarray(rgb, np.float32).copy()
    h = heatmap / max(float(heatmap.max()), 1e-6)
    mask = h > 0
    out[mask] = (1 - alpha * h[mask, None]) * out[mask] + alpha * h[
        mask, None
    ] * np.array([1.0, 0.05, 0.05])
    return np.clip(out, 0, 1)


def _project_voxels(grid, coords: np.ndarray, pose: np.ndarray,
                    intrinsics: np.ndarray, height: int, width: int):
    """Project voxel coords into pixel space -> (px, py, z, keep_mask)."""
    world = _world(grid, coords)
    w2c = np.linalg.inv(np.asarray(pose, np.float64))
    cam = world @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    px = intrinsics[0, 0] * cam[:, 0] / np.maximum(z, 1e-9) + intrinsics[0, 2]
    py = intrinsics[1, 1] * cam[:, 1] / np.maximum(z, 1e-9) + intrinsics[1, 2]
    keep = (z > 1e-6) & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    return px, py, z, keep


def render_density_projection(grid, pose: np.ndarray,
                              intrinsics: np.ndarray,
                              height: int, width: int,
                              *, reduce: str = "max") -> np.ndarray:
    """Camera-space density projection image [H, W] (the reference's
    render_density_from_camera, floater_visualization.py:583): every
    active voxel splats its density at its projected pixel; `reduce`
    picks max (x-ray view) or sum."""
    links = _host(grid.links)
    coords = np.argwhere(links >= 0)
    dens = _host(grid.density_data)[
        links[coords[:, 0], coords[:, 1], coords[:, 2]], 0
    ]
    px, py, _, keep = _project_voxels(
        grid, coords, pose, intrinsics, height, width
    )
    img = np.zeros((height, width), np.float32)
    xi = px[keep].astype(np.int64)
    yi = py[keep].astype(np.int64)
    d = np.maximum(dens[keep], 0.0).astype(np.float32)
    if reduce == "max":
        np.maximum.at(img, (yi, xi), d)
    else:
        np.add.at(img, (yi, xi), d)
    return img


def component_overlay(rgb: np.ndarray, grid, pose: np.ndarray,
                      intrinsics: np.ndarray, *,
                      threshold: float = 0.01,
                      min_object_size: int = 100,
                      alpha: float = 0.75,
                      max_components: int = 12) -> np.ndarray:
    """Per-component voxel overlay: the main object tinted green, each
    floater component a distinct color (reference
    create_multi_object_voxel_overlay:290 + main-object variant:487).
    rgb: [H, W, 3] render in [0, 1]."""
    H, W = rgb.shape[:2]
    occ, floater, labels, main_label, sizes = floater_masks(
        grid, threshold=threshold, min_object_size=min_object_size,
        return_labels=True,
    )
    out = np.asarray(rgb, np.float32).copy()
    if main_label == 0:
        return out

    palette = np.array([
        [1.0, 0.15, 0.15], [1.0, 0.6, 0.1], [1.0, 1.0, 0.2],
        [0.7, 0.3, 1.0], [0.2, 0.8, 1.0], [1.0, 0.3, 0.7],
        [0.6, 1.0, 0.3], [0.3, 0.5, 1.0], [1.0, 0.8, 0.5],
        [0.8, 0.2, 0.4], [0.4, 0.9, 0.8], [0.9, 0.9, 0.9],
    ])
    # components by size, largest floaters first (main excluded)
    comp_ids = [
        int(l) for l in np.argsort(sizes)[::-1]
        if l and l != main_label and sizes[l] > 0
    ][:max_components]

    def _splat(mask_vol, color, a):
        coords = np.argwhere(mask_vol)
        if len(coords) == 0:
            return
        px, py, _, keep = _project_voxels(
            grid, coords, pose, intrinsics, H, W
        )
        yi = py[keep].astype(np.int64)
        xi = px[keep].astype(np.int64)
        out[yi, xi] = (1 - a) * out[yi, xi] + a * np.asarray(color)

    _splat(labels == main_label, [0.1, 1.0, 0.2], alpha * 0.35)
    for i, l in enumerate(comp_ids):
        _splat(labels == l, palette[i % len(palette)], alpha)
    return np.clip(out, 0, 1)


def floater_panel(grid, out_path: str, *, threshold: float = 0.01,
                  min_object_size: int = 100, n_slices: int = 4) -> str:
    """Multi-panel floater report figure: n_slices slices along each of
    the three axes (floaters red, main object gray) + component-size
    histogram + summary stats — the slice-panel depth of the reference's
    standalone figure set."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from nerf_projects_tpu_torch.obs.theme import apply_theme

    apply_theme()
    occ, floater, labels, main_label, sizes = floater_masks(
        grid, threshold=threshold, min_object_size=min_object_size,
        return_labels=True,
    )
    fig, axes = plt.subplots(
        4, n_slices, figsize=(3.2 * n_slices, 12.5)
    )
    fig.suptitle(
        f"Floater analysis — {int(floater.sum())} floater voxels, "
        f"threshold {threshold}", fontweight="bold",
    )
    for ax_i in range(3):
        reso = occ.shape[ax_i]
        for j, frac in enumerate(np.linspace(0.2, 0.8, n_slices)):
            idx = int(frac * (reso - 1))
            sl = [slice(None)] * 3
            sl[ax_i] = idx
            img = np.zeros(occ[tuple(sl)].shape + (3,), np.float32)
            img[occ[tuple(sl)]] = [0.7, 0.7, 0.7]
            img[floater[tuple(sl)]] = [1.0, 0.1, 0.1]
            ax = axes[ax_i, j]
            ax.imshow(img, origin="lower")
            ax.set_title(f"axis {'xyz'[ax_i]} @ {idx}", fontsize=9)
            ax.axis("off")
    # bottom row: component-size histogram + stats
    comp_sizes = sorted(
        [int(s) for l, s in enumerate(sizes)
         if l and l != main_label and s > 0],
        reverse=True,
    )
    axh = axes[3, 0]
    if comp_sizes:
        axh.bar(range(len(comp_sizes[:30])), comp_sizes[:30],
                color="#d62728")
        axh.set_yscale("log")
    axh.set_title("floater sizes (voxels)", fontsize=9)
    axs = axes[3, 1]
    total = int(occ.sum())
    stats = [
        f"components: {int((sizes > 0).sum())}",
        f"main object: {int(sizes[main_label]) if main_label else 0} vox",
        f"floaters: {len(comp_sizes)} ({int(floater.sum())} vox)",
        f"FDR: {floater.sum() / max(total, 1):.5f}",
    ]
    axs.text(0.02, 0.95, "\n".join(stats), va="top", family="monospace",
             fontsize=10, transform=axs.transAxes)
    axs.axis("off")
    for j in range(2, n_slices):
        axes[3, j].axis("off")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def log_floater_visualizations(
    tb,
    grid,
    step: int,
    *,
    cameras=None,
    renders=None,
    gt_images=None,
    threshold: float = 0.01,
    min_object_size: int = 100,
    n_slices: int = 3,
    max_views: int = 3,
):
    """Log the floater visualization set to TensorBoard during training
    eval steps (floater_visualization.py:635
    log_floater_visualizations_to_tensorboard, hooked at opt.py:580-668).

    tb: obs.tb.SummaryWriter (or any object with .image/.scalar).
    cameras: list of (pose_c2w, intrinsics, H, W). Returns the number of
    images logged.
    """
    occ, floater = floater_masks(
        grid, threshold=threshold, min_object_size=min_object_size
    )
    n_logged = 0
    tb.scalar("floaters/voxels", float(floater.sum()), step)

    # axis slices with floaters highlighted
    reso = occ.shape[2]
    for i, frac in enumerate(np.linspace(0.25, 0.75, n_slices)):
        idx = int(frac * (reso - 1))
        img = np.zeros(occ.shape[:2] + (3,), np.float32)
        img[occ[:, :, idx]] = [0.7, 0.7, 0.7]
        img[floater[:, :, idx]] = [1.0, 0.1, 0.1]
        tb.image(f"floaters/slice_z{idx}", img, step)
        n_logged += 1

    if cameras is not None:
        for i, cam in enumerate(cameras[:max_views]):
            pose, K, H, W = cam
            heat = project_floaters_to_view(
                grid, floater, pose, K, H, W
            )
            if heat is None:
                continue
            hn = heat / max(float(heat.max()), 1e-6)
            tb.image(f"floaters/heatmap_view_{i}", hn[..., None].repeat(3, -1), step)
            n_logged += 1
            if renders is not None and i < len(renders):
                tb.image(
                    f"floaters/overlay_view_{i}",
                    overlay_on_render(np.asarray(renders[i]), heat),
                    step,
                )
                n_logged += 1
            if gt_images is not None and i < len(gt_images):
                tb.image(f"floaters/gt_view_{i}", np.asarray(gt_images[i]), step)
                n_logged += 1
    return n_logged
