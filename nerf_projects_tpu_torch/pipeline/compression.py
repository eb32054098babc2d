"""PlenOctree compression: median-cut palette quantization of SH data (port
of ``nerf_projects_tpu/pipeline/compression.py``).

Parity target: reference plenoctree/octree/compression.py:
  * leaves with sigma below ``sigma_thresh`` zeroed (:156-160);
  * each SH basis function's rgb triple over all cells quantized by
    median cut to a palette of at most ``n_colors`` (svox
    ``_C.quantize_median_cut``, :186-188): uint16 ids, a float16 palette;
  * the first ``retain`` low-order coefficient groups kept unquantized
    (:168-173);
  * deflated with ``np.savez_compressed`` (:226), the tree's bookkeeping
    dropped.

The median cut is the native host op (``utils/native.py``); a failed
build raises, nothing falls back to Python. The bases' cuts are
independent and run on host threads at once (ctypes lets go of the GIL).
The file's keys are the JAX package's, so either package reads the
other's files.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.models.octree import PlenOctree


def median_cut(vectors: np.ndarray, n_colors: int) -> Tuple[np.ndarray, np.ndarray]:
    """Median-cut vector quantization of vectors [N, C]: (palette [K, C]
    float16, ids [N] uint16 / uint32), K <= n_colors. Deterministic."""
    if len(vectors) == 0:
        return np.zeros((1, vectors.shape[1]), np.float16), np.zeros(0, np.uint16)
    from nerf_projects_tpu_torch.utils import native

    return native.median_cut(np.asarray(vectors, np.float32), n_colors)


def compress_octree(tree: PlenOctree, path: str, *, n_colors: int = 65536, sigma_thresh: float = 1.0,
                    retain: int = 1) -> dict:
    """Quantize and save. Returns the bytes before and after and their
    ratio."""
    data = tree.data.detach().cpu().numpy().astype(np.float32)
    flat = data.reshape(-1, tree.data_dim).copy()
    # sigma kill: zero out data of near-empty leaves (compression.py:156)
    flat[flat[:, -1] < sigma_thresh] = 0.0

    basis_dim = (tree.data_dim - 1) // 3
    retain = max(0, min(retain, basis_dim))
    quant_payload = {}
    bases = range(retain, basis_dim)
    with ThreadPoolExecutor(max_workers=max(1, min(len(bases), os.cpu_count() or 1))) as pool:
        cuts = pool.map(lambda b: median_cut(np.ascontiguousarray(flat[:, 3 * b: 3 * (b + 1)]), n_colors), bases)
        for b, (palette, ids) in zip(bases, cuts):
            quant_payload[f"palette_{b}"] = palette
            quant_payload[f"ids_{b}"] = ids

    np.savez_compressed(
        path,
        child=tree.child_host,
        invradius3=tree.invradius,
        offset=tree.offset,
        depth_limit=tree.depth_limit,
        data_dim=tree.data_dim,
        basis_dim=basis_dim,
        retain=retain,
        sigma=flat[:, -1].astype(np.float16),
        data_retained=flat[:, : 3 * retain].astype(np.float16),
        **quant_payload,
    )
    raw_bytes = data.nbytes + tree.child_host.nbytes
    comp_bytes = os.path.getsize(path)
    return {"raw_bytes": raw_bytes, "compressed_bytes": comp_bytes,
            "compression_ratio": raw_bytes / max(comp_bytes, 1)}


def load_compressed_octree(path: str, device: Optional[Union[str, torch.device]] = None) -> PlenOctree:
    """Rebuild a renderable tree from the quantized npz
    (compressed_evaluation.py:82-215 equivalent) on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    z = np.load(path)
    child = z["child"].astype(np.int32)
    data_dim = int(z["data_dim"])
    basis_dim = int(z["basis_dim"])
    retain = int(z["retain"])
    flat = np.zeros((child.size, data_dim), np.float32)
    flat[:, : 3 * retain] = z["data_retained"].astype(np.float32)
    for b in range(retain, basis_dim):
        palette = z[f"palette_{b}"].astype(np.float32)
        flat[:, 3 * b: 3 * (b + 1)] = palette[z[f"ids_{b}"].astype(np.int64)]
    flat[:, -1] = z["sigma"].astype(np.float32)
    data = torch.from_numpy(flat.reshape(child.shape + (data_dim,))).to(dev)
    return PlenOctree(child, data, z["invradius3"].astype(np.float32), z["offset"].astype(np.float32),
                      int(z["depth_limit"]))
