"""Advanced quality-science metrics: MCQ, SMEI, FDR (port of
``nerf_projects_tpu/obs/advanced_metrics.py``; host numpy and scipy, a
grid's tensors read back first).

Parity target: reference svox2/opt/util/advanced_metrics.py —
  * compute_MCQ (:36-71): peak-device-GB / PSNR (GB per dB, lower better);
  * compute_SMEI (:74-167): deprecated disk-efficiency index, kept for
    log-format compatibility;
  * compute_FDR (:168-469): floater detection — density-thresholded
    occupancy, 26-connected components (scipy), adaptive gap-based
    classification of small disconnected components as floaters;
  * compute_all_advanced_metrics (:470).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def compute_mcq(psnr: float, peak_memory_mb: float) -> Dict[str, float]:
    peak_gb = peak_memory_mb / 1024.0
    mcq = peak_gb / psnr if psnr > 0 else 0.0
    return {
        "MCQ": mcq,
        "peak_gpu_gb": peak_gb,
        "peak_gpu_mb": peak_memory_mb,
        "psnr": psnr,
        "memory_per_db": mcq,
    }


def compute_smei(
    psnr: float, storage_bytes: int, baseline_psnr: float = 30.0,
    baseline_bytes: int = 2**30,
) -> Dict[str, float]:
    """Deprecated storage-efficiency index (kept for log compat)."""
    storage_gb = storage_bytes / 1e9
    smei = (psnr / max(storage_gb, 1e-9)) / (baseline_psnr / (baseline_bytes / 1e9))
    return {"SMEI": smei, "storage_gb": storage_gb, "deprecated": True}


def _occupancy_from_grid(grid, threshold: float, use_density_threshold: bool):
    links = grid.links.cpu().numpy()
    active = links >= 0
    if use_density_threshold and threshold > 0:
        dens = np.zeros(links.shape, np.float32)
        dens[active] = grid.density_data.detach().cpu().numpy()[links[active], 0]
        return dens >= threshold
    return active


def compute_fdr(
    grid=None,
    *,
    occupancy: Optional[np.ndarray] = None,
    threshold: float = 0.01,
    main_object_threshold: float = 0.05,
    use_density_threshold: bool = True,
    min_object_size: int = 1000,
    size_gap_ratio: float = 0.2,
    use_adaptive: bool = True,
    connectivity: int = 26,
) -> Dict[str, float]:
    """Floater Detection Ratio over a SparseGrid (or a raw occupancy mask)."""
    from scipy import ndimage

    if occupancy is None:
        occupancy = _occupancy_from_grid(grid, threshold, use_density_threshold)
    occupancy = np.asarray(occupancy, bool)
    total = int(occupancy.sum())
    sparsity = 1.0 - total / occupancy.size
    if total == 0:
        return {
            "FDR": 0.0,
            "num_floaters": 0,
            "num_components": 0,
            "main_volume": 0,
            "floater_volume": 0,
            "total_volume": 0,
            "sparsity": sparsity,
            "detection_method": "empty",
        }

    struct = ndimage.generate_binary_structure(3, {6: 1, 18: 2, 26: 3}[connectivity])
    labels, n_comp = ndimage.label(occupancy, structure=struct)
    sizes = np.sort(np.bincount(labels.ravel())[1:])[::-1]  # descending

    if use_adaptive:
        # Adaptive gap detection: components after a sharp size drop (ratio
        # < size_gap_ratio) or below min_object_size are floaters.
        n_main = 1
        for i in range(1, len(sizes)):
            if sizes[i] < min_object_size:
                break
            if sizes[i] / sizes[i - 1] < size_gap_ratio:
                break
            n_main += 1
        method = "adaptive_gap"
    else:
        n_main = int(
            (sizes >= max(sizes[0] * main_object_threshold, 1)).sum()
        )
        method = "relative_threshold"

    floaters = sizes[n_main:]
    floater_volume = int(floaters.sum())
    return {
        "FDR": floater_volume / total,
        "num_floaters": int(len(floaters)),
        "num_components": int(n_comp),
        "main_volume": int(sizes[0]),
        "floater_volume": floater_volume,
        "total_volume": total,
        "sparsity": float(sparsity),
        "largest_floater": int(floaters[0]) if len(floaters) else 0,
        "mean_floater_size": float(floaters.mean()) if len(floaters) else 0.0,
        "num_main_objects": int(n_main),
        "detection_method": method,
    }


def compute_all_advanced_metrics(
    grid,
    psnr: float,
    peak_memory_mb: float,
    *,
    storage_bytes: Optional[int] = None,
    fdr_kwargs: Optional[dict] = None,
) -> Dict[str, float]:
    out: Dict[str, float] = {}
    out.update({f"mcq_{k}" if k not in ("MCQ",) else k: v
                for k, v in compute_mcq(psnr, peak_memory_mb).items()})
    if storage_bytes is not None:
        out.update(compute_smei(psnr, storage_bytes))
    out.update(compute_fdr(grid, **(fdr_kwargs or {})))
    return out
