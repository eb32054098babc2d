"""Positional (Fourier-feature) encoding (port of
``nerf_projects_tpu/ops/posenc.py``).

Orderings: "interleaved" [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...],
the vanilla-NeRF Embedder (reference nerf/embedder.py), and "block"
[x, sin(2^m x .. 2^(M-1) x), sin(... + pi/2)], the NeRF-SH reference's
posenc (plenoctree/nerf_sh/nerf/model_utils.py:145-173). Both
are one sin over a flat [..., 2*F*D] argument, cos taken as
sin(x + pi/2), with frequency constants computed in float64 and cast to
the input's dtype — as the reference package does, so the two agree.
"""
from __future__ import annotations

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import device_constant


def posenc_dim(in_dim: int, num_freqs: int, include_input: bool = True) -> int:
    """Output feature dim of `posenc`."""
    return in_dim * (2 * num_freqs + (1 if include_input else 0))


def posenc(
    x: torch.Tensor,
    num_freqs: int,
    *,
    min_deg: int = 0,
    include_input: bool = True,
    ordering: str = "interleaved",
    log_sampling: bool = True,
) -> torch.Tensor:
    """Encode [..., D] with frequencies 2^min_deg .. 2^(min_deg+num_freqs-1).

    Returns [..., D * (2*num_freqs + include_input)].
    """
    if num_freqs == 0:
        return x
    D = x.shape[-1]
    if log_sampling:
        freqs = 2.0 ** np.arange(min_deg, min_deg + num_freqs, dtype=np.float64)
    else:
        freqs = np.linspace(
            2.0 ** min_deg, 2.0 ** (min_deg + num_freqs - 1), num_freqs,
            dtype=np.float64,
        )
    j = np.arange(2 * num_freqs * D)
    if ordering == "interleaved":
        f_idx = (j // D) // 2
        sc = (j // D) % 2
    elif ordering == "block":
        sc = j // (num_freqs * D)
        f_idx = (j // D) % num_freqs
    else:
        raise ValueError(f"unknown posenc ordering: {ordering!r}")
    # kept on the device: a copy of host numbers to the card waits for its queue
    freq_vec = device_constant(freqs[f_idx], x.dtype, x.device)
    phase_vec = device_constant(sc * (0.5 * np.pi), x.dtype, x.device)
    xt = x.repeat(*((1,) * (x.ndim - 1)), 2 * num_freqs)
    four = torch.sin(xt * freq_vec + phase_vec)
    if include_input:
        return torch.cat([x, four], dim=-1)
    return four
