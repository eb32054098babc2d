"""The vanilla NeRF MLP as an ``nn.Module`` (port of
``nerf_projects_tpu/models/nerf.py``).

Reference nerf/nerf.py:8-111: a trunk of `depth` layers of `width`, with
the encoded input concatenated in front of the activations after layer 4
([x, h]); with viewdirs, a sigma head off the trunk, a bottleneck, one
width/2 layer over [bottleneck, views] and the rgb head. Without viewdirs,
one `output_ch` head. Parameters are float32; the matmuls run in
`compute_dtype`, and the raw output [..., 4] (rgb logits, sigma logit)
is float32.

Layer names follow the flax module (trunk_i, sigma_head, bottleneck,
view_0, rgb_head, output), so `flax_to_state_dict` carries a flax
parameter tree across.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


class NeRFMLP(nn.Module):
    def __init__(
        self,
        *,
        depth: int = 8,
        width: int = 256,
        skips: Sequence[int] = (4,),
        use_viewdirs: bool = False,
        output_ch: int = 4,
        in_ch: int = 63,
        in_ch_views: int = 27,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        self.compute_dtype = compute_dtype
        fan_in = [in_ch] + [width + (in_ch if i in self.skips else 0) for i in range(depth - 1)]
        self.trunk = nn.ModuleList(nn.Linear(f, width) for f in fan_in)
        if use_viewdirs:
            self.sigma_head = nn.Linear(width, 1)
            self.bottleneck = nn.Linear(width, width)
            self.view_0 = nn.Linear(width + in_ch_views, width // 2)
            self.rgb_head = nn.Linear(width // 2, 3)
        else:
            self.output = nn.Linear(width, output_ch)

    def reset_parameters(self, generator: torch.Generator) -> "NeRFMLP":
        """Flax's Dense init from ``generator``: lecun-normal kernels (a
        normal truncated at two standard deviations, rescaled to unit
        variance over fan_in) and zero biases."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
                with torch.no_grad():
                    nn.init.trunc_normal_(
                        layer.weight, std=std, a=-2.0 * std, b=2.0 * std,
                        generator=generator,
                    )
                    layer.bias.zero_()
        return self

    def _dense(self, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(h, layer.weight.to(dt), layer.bias.to(dt))

    def forward(self, pts_enc: torch.Tensor, views_enc: Optional[torch.Tensor] = None):
        """pts_enc [..., Cp], views_enc [..., Cv] -> raw [..., 4] float32."""
        x = pts_enc.to(self.compute_dtype)
        h = x
        for i, layer in enumerate(self.trunk):
            h = F.relu(self._dense(layer, h))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        if self.use_viewdirs:
            if views_enc is None:
                raise ValueError("use_viewdirs=True requires views_enc")
            sigma = self._dense(self.sigma_head, h)
            feat = self._dense(self.bottleneck, h)
            v = torch.cat([feat, views_enc.to(self.compute_dtype)], dim=-1)
            v = F.relu(self._dense(self.view_0, v))
            raw = torch.cat([self._dense(self.rgb_head, v), sigma], dim=-1)
        else:
            raw = self._dense(self.output, h)
        return raw.float()


def flax_to_state_dict(tree: Mapping) -> dict:
    """A flax NeRFMLP parameter tree of numpy arrays -> the port's
    ``NeRFMLP`` state dict. Flax kernels are [in, out]; ``nn.Linear``
    weights are [out, in]."""
    p = tree["params"] if "params" in tree else tree
    state = {}
    for name, leaf in p.items():
        key = f"trunk.{name.split('_')[1]}" if name.startswith("trunk_") else name
        state[f"{key}.weight"] = torch.tensor(np.asarray(leaf["kernel"], np.float32).T)
        state[f"{key}.bias"] = torch.tensor(np.asarray(leaf["bias"], np.float32))
    return state
