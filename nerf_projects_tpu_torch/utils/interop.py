"""Cross-framework checkpoint interop (port of
``nerf_projects_tpu/utils/interop.py``).

  * ``nerf_params_from_keras`` (reference nerf/nerf.py:113-146): the
    original TF-NeRF Keras weight list as a flax-layout NeRFMLP parameter
    tree of numpy arrays; ``models/nerf.py::flax_to_state_dict`` turns it
    into the port's ``NeRFMLP`` state dict.
  * ``nerf_sh_params_from_jaxnerf`` (reference
    plenoctree/octree/nerf/models.py:66-114): a jaxnerf / PlenOctree flax
    checkpoint tree renamed into NeRFSHModel's; kept in
    ``models/nerf_sh.py`` and re-exported here.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from nerf_projects_tpu_torch.models.nerf_sh import nerf_sh_params_from_jaxnerf

__all__ = ["nerf_params_from_keras", "nerf_sh_params_from_jaxnerf"]


def nerf_params_from_keras(weights: List[np.ndarray], *, depth: int = 8) -> Dict:
    """Keras weight list -> NeRFMLP flax-layout params (use_viewdirs=True).

    Layout (nerf.py:113-146): [W, b] per trunk layer (2 * depth entries),
    then the feature (bottleneck), views (view_0), rgb and alpha (sigma)
    heads.
    """
    p: Dict[str, Any] = {}
    for i in range(depth):
        p[f"trunk_{i}"] = {
            "kernel": np.asarray(weights[2 * i], np.float32),
            "bias": np.asarray(weights[2 * i + 1], np.float32),
        }
    idx = 2 * depth
    for k, name in enumerate(("bottleneck", "view_0", "rgb_head", "sigma_head")):
        p[name] = {
            "kernel": np.asarray(weights[idx + 2 * k], np.float32),
            "bias": np.asarray(weights[idx + 2 * k + 1], np.float32),
        }
    return {"params": p}
