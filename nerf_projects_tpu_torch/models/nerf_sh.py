"""NeRF with spherical-harmonic / spherical-Gaussian radiance heads (port
of ``nerf_projects_tpu/models/nerf_sh.py``).

Reference plenoctree/nerf_sh/nerf/models.py:52-428 and
model_utils.py:30-94:
  * trunk of depth 8 x width 256 with the input concatenated after the
    layers i where i % skip_layer == 0 and i > 0 ([h, x]);
  * an optional condition branch (viewdirs): bottleneck, concat with the
    encoded directions, net_depth_condition layers of width 128;
  * a radiance head of 3 channels (plain / viewdirs), 3 (deg+1)^2 SH
    coefficients decoded against the view direction, or 3 sg_dim SG
    amplitudes with learnable lobes (``sg_lambda``, ``sg_mu_spher``);
  * noise on raw sigma before its activation when randomized;
  * coarse + fine sampling with the jaxnerf pdf and disparity numerics.

``CondMLP`` keeps its layers in ``dense``, numbered as flax numbers its
``Dense_i``: trunk 0..7, sigma head 8, then the bottleneck, the condition
layers and the rgb head. ``nerf_sh_flax_to_state_dict`` and
``cond_mlp_flax_to_state_dict`` carry a flax parameter tree across; ``nerf_sh_params_from_jaxnerf`` (a copy of
``utils/interop.py``'s) renames a jaxnerf / PlenOctree checkpoint tree
first. With ``use_fused_trunk`` a condition-free full-width trunk runs
through the fused kernels (``ops/kernels/fused_sh_mlp.py``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.ops import sg as sg_ops
from nerf_projects_tpu_torch.ops import sh as sh_ops
from nerf_projects_tpu_torch.ops.kernels import fused_sh_mlp
from nerf_projects_tpu_torch.ops.posenc import posenc, posenc_dim
from nerf_projects_tpu_torch.ops.render import RenderOutputs, volumetric_rendering
from nerf_projects_tpu_torch.ops.sampling import cast_rays, sample_pdf, stratified_sample

ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "elu": F.elu,
}


class CondMLP(nn.Module):
    """Trunk + optional condition branch (reference model_utils.MLP)."""

    def __init__(
        self,
        *,
        in_ch: int = 63,
        in_ch_condition: Optional[int] = None,
        net_depth: int = 8,
        net_width: int = 256,
        net_depth_condition: int = 1,
        net_width_condition: int = 128,
        skip_layer: int = 4,
        num_rgb_channels: int = 3,
        num_sigma_channels: int = 1,
        net_activation: Callable = F.relu,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.net_depth = net_depth
        self.skip_layer = skip_layer
        self.has_condition = in_ch_condition is not None
        self.net_depth_condition = net_depth_condition
        self.net_activation = net_activation
        self.compute_dtype = compute_dtype
        dims = []
        feat = in_ch
        for i in range(net_depth):
            dims.append((feat, net_width))
            feat = net_width + (in_ch if i % skip_layer == 0 and i > 0 else 0)
        dims.append((feat, num_sigma_channels))
        if self.has_condition:
            dims.append((feat, net_width))
            feat = net_width + in_ch_condition
            for _ in range(net_depth_condition):
                dims.append((feat, net_width_condition))
                feat = net_width_condition
        dims.append((feat, num_rgb_channels))
        self.dense = nn.ModuleList(nn.Linear(i, o) for i, o in dims)

    def reset_parameters(self, generator: torch.Generator) -> "CondMLP":
        """Flax's init from ``generator``: glorot-uniform kernels, zero
        biases."""
        with torch.no_grad():
            for layer in self.dense:
                o, i = layer.weight.shape
                a = math.sqrt(6.0 / (i + o))
                layer.weight.uniform_(-a, a, generator=generator)
                layer.bias.zero_()
        return self

    def _dense(self, i: int, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(h, self.dense[i].weight.to(dt), self.dense[i].bias.to(dt))

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None):
        """x [N, feat] encoded points; condition [N, feat_c] encoded
        directions, one row a sample. Returns (raw_rgb [N, R], raw_sigma
        [N, S]) in float32."""
        if self.has_condition != (condition is not None):
            raise ValueError("the condition must be given exactly when the MLP has a condition branch")
        x = x.to(self.compute_dtype)
        inputs = x
        for i in range(self.net_depth):
            x = self.net_activation(self._dense(i, x))
            if i % self.skip_layer == 0 and i > 0:
                x = torch.cat([x, inputs], dim=-1)
        j = self.net_depth
        raw_sigma = self._dense(j, x)
        j += 1
        if condition is not None:
            bottleneck = self._dense(j, x)
            j += 1
            x = torch.cat([bottleneck, condition.to(self.compute_dtype)], dim=-1)
            for _ in range(self.net_depth_condition):
                x = self.net_activation(self._dense(j, x))
                j += 1
        raw_rgb = self._dense(j, x)
        return raw_rgb.float(), raw_sigma.float()


class NeRFSHModel(nn.Module):
    """Coarse+fine NeRF with plain / viewdirs / SH / SG radiance output.
    ``forward`` returns a RenderOutputs per level, coarse first."""

    def __init__(
        self,
        *,
        num_coarse_samples: int = 64,
        num_fine_samples: int = 128,
        use_viewdirs: bool = False,
        sh_deg: int = -1,
        sg_dim: int = -1,
        near: float = 2.0,
        far: float = 6.0,
        noise_std: Optional[float] = None,
        net_depth: int = 8,
        net_width: int = 256,
        net_depth_condition: int = 1,
        net_width_condition: int = 128,
        skip_layer: int = 4,
        num_sigma_channels: int = 1,
        white_bkgd: bool = True,
        min_deg_point: int = 0,
        max_deg_point: int = 10,
        deg_view: int = 4,
        lindisp: bool = False,
        rgb_activation: Callable = torch.sigmoid,
        sigma_activation: Callable = F.relu,
        net_activation: Callable = F.relu,
        compute_dtype: torch.dtype = torch.float32,
        use_fused_trunk: bool = False,
    ):
        super().__init__()
        if sh_deg >= 0 and (use_viewdirs or sg_dim > 0):
            raise ValueError("use at most one of: SH, SG, use_viewdirs")
        if sg_dim > 0 and use_viewdirs:
            raise ValueError("use at most one of: SH, SG, use_viewdirs")
        self.num_coarse_samples = num_coarse_samples
        self.num_fine_samples = num_fine_samples
        self.use_viewdirs = use_viewdirs
        self.sh_deg = sh_deg
        self.sg_dim = sg_dim
        self.near = near
        self.far = far
        self.noise_std = noise_std
        self.net_depth = net_depth
        self.net_width = net_width
        self.skip_layer = skip_layer
        self.num_sigma_channels = num_sigma_channels
        self.white_bkgd = white_bkgd
        self.min_deg_point = min_deg_point
        self.max_deg_point = max_deg_point
        self.deg_view = deg_view
        self.lindisp = lindisp
        self.rgb_activation = rgb_activation
        self.sigma_activation = sigma_activation
        self.net_activation = net_activation
        self.use_fused_trunk = use_fused_trunk

        def mlp():
            return CondMLP(
                in_ch=posenc_dim(3, max_deg_point - min_deg_point),
                in_ch_condition=posenc_dim(3, deg_view) if use_viewdirs else None,
                net_depth=net_depth, net_width=net_width, net_depth_condition=net_depth_condition,
                net_width_condition=net_width_condition, skip_layer=skip_layer,
                num_rgb_channels=self.num_rgb_channels, num_sigma_channels=num_sigma_channels,
                net_activation=net_activation, compute_dtype=compute_dtype,
            )

        self.mlp_coarse = mlp()
        self.mlp_fine = mlp() if num_fine_samples > 0 else None
        if sg_dim > 0:
            self.sg_lambda = nn.Parameter(torch.ones(sg_dim))
            self.sg_mu_spher = nn.Parameter(torch.zeros(sg_dim, 2))

    @property
    def num_rgb_channels(self) -> int:
        if self.sh_deg >= 0:
            return 3 * (self.sh_deg + 1) ** 2
        if self.sg_dim > 0:
            return 3 * self.sg_dim
        return 3

    def reset_parameters(self, generator: torch.Generator) -> "NeRFSHModel":
        """Flax's init from ``generator``: the MLPs (coarse, then fine), then
        sg_lambda = 1 and the lobes' (theta, phi) uniform in [0, pi) x
        [0, 2 pi)."""
        for m in (self.mlp_coarse, self.mlp_fine):
            if m is not None:
                m.reset_parameters(generator)
        if self.sg_dim > 0:
            with torch.no_grad():
                self.sg_lambda.fill_(1.0)
                u = torch.rand(self.sg_dim, 2, generator=generator)
                self.sg_mu_spher.copy_(u * torch.tensor([math.pi, 2.0 * math.pi]))
        return self

    # -- helpers ----------------------------------------------------------

    def _encode_points(self, pts: torch.Tensor) -> torch.Tensor:
        return posenc(pts, self.max_deg_point - self.min_deg_point, min_deg=self.min_deg_point,
                      ordering="block", include_input=True)

    def _encode_views(self, viewdirs: torch.Tensor) -> torch.Tensor:
        return posenc(viewdirs, self.deg_view, min_deg=0, ordering="block", include_input=True)

    def _fused_trunk_ok(self) -> bool:
        # The fused kernel hardcodes relu and one sigma channel; gate on
        # both, so that softplus / elu configurations run the modules
        # instead of computing wrong outputs.
        return (
            self.use_fused_trunk
            and not self.use_viewdirs
            and self.net_depth == 8
            and self.net_width == 256
            and self.skip_layer == 4
            and self.min_deg_point == 0
            and self.max_deg_point == 10
            and self.num_rgb_channels <= 128
            and self.num_sigma_channels == 1
            and self.net_activation is F.relu
        )

    def _run_mlp(self, mlp: CondMLP, pts: torch.Tensor, viewdirs_enc: Optional[torch.Tensor]):
        """pts [R, N, 3]; viewdirs_enc [R, Cv] or None -> ([R, N, Crgb], [R, N, S])."""
        r, n = pts.shape[0], pts.shape[1]
        pts_enc = self._encode_points(pts.reshape(r * n, 3))
        if viewdirs_enc is None and self._fused_trunk_ok():
            raw_rgb, raw_sigma = fused_sh_mlp.fused_sh_apply(mlp, pts_enc, self.num_rgb_channels)
        else:
            cond = None
            if viewdirs_enc is not None:
                cond = viewdirs_enc[:, None, :].expand(r, n, viewdirs_enc.shape[-1]).reshape(r * n, -1)
            raw_rgb, raw_sigma = mlp(pts_enc, cond)
        return raw_rgb.reshape(r, n, -1), raw_sigma.reshape(r, n, self.num_sigma_channels)

    def _decode_radiance(self, raw_rgb: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
        """SH / SG decode of the raw head outputs against per-ray viewdirs."""
        if self.sh_deg >= 0:
            coeffs = raw_rgb.reshape(raw_rgb.shape[:-1] + (3, (self.sh_deg + 1) ** 2))
            return sh_ops.eval_sh(self.sh_deg, coeffs, viewdirs[:, None, :])
        if self.sg_dim > 0:
            coeffs = raw_rgb.reshape(raw_rgb.shape[:-1] + (3, self.sg_dim))
            return sg_ops.eval_sg(self.sg_lambda, self.sg_mu_spher, coeffs, viewdirs[:, None, :])
        return raw_rgb

    def _one_level(self, generator, mlp, pts, z_vals, rays: Rays, viewdirs_enc, randomized) -> RenderOutputs:
        raw_rgb, raw_sigma = self._run_mlp(mlp, pts, viewdirs_enc)
        if self.noise_std and randomized:
            raw_sigma = raw_sigma + torch.randn(
                raw_sigma.shape, generator=generator, device=raw_sigma.device) * self.noise_std
        rgb = self.rgb_activation(self._decode_radiance(raw_rgb, rays.viewdirs))
        sigma = self.sigma_activation(raw_sigma)
        return volumetric_rendering(rgb, sigma[..., 0], z_vals, rays.directions,
                                    white_bkgd=self.white_bkgd, disp_mode="jaxnerf")

    # -- public API -------------------------------------------------------

    def forward(self, rays: Rays, randomized: bool,
                generator: Optional[torch.Generator] = None) -> List[RenderOutputs]:
        """Render [R] rays: coarse (and fine) RenderOutputs. When
        randomized, ``generator`` draws the stratified depths, then the
        coarse sigma noise, the pdf uniforms and the fine sigma noise, in
        that order."""
        if randomized and generator is None:
            raise ValueError("randomized rendering requires a generator")
        z_vals = stratified_sample(
            generator, self.num_coarse_samples, self.near, self.far, rays.origins.shape[:-1],
            lindisp=self.lindisp, randomized=randomized, device=rays.origins.device,
        )
        pts = cast_rays(z_vals, rays.origins, rays.directions)
        viewdirs_enc = self._encode_views(rays.viewdirs) if self.use_viewdirs else None
        coarse = self._one_level(generator, self.mlp_coarse, pts, z_vals, rays, viewdirs_enc, randomized)
        levels = [coarse]
        if self.num_fine_samples > 0:
            z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_vals_f, pts_f = sample_pdf(
                generator, z_mids, coarse.weights[..., 1:-1], rays.origins, rays.directions, z_vals,
                self.num_fine_samples, randomized=randomized, mode="jaxnerf",
            )
            levels.append(self._one_level(generator, self.mlp_fine, pts_f, z_vals_f, rays, viewdirs_enc,
                                          randomized))
        return levels

    def eval_points_raw(self, points: torch.Tensor, viewdirs: Optional[torch.Tensor] = None,
                        coarse: bool = False):
        """Raw (rgb-or-coefficients, sigma) at [B, 3] points, the grid
        extraction entry point (models.py:146-181)."""
        mlp = self.mlp_coarse if (coarse or self.num_fine_samples <= 0) else self.mlp_fine
        viewdirs_enc = None
        if self.use_viewdirs:
            if viewdirs is None:
                raise ValueError("use_viewdirs model needs viewdirs")
            viewdirs_enc = self._encode_views(viewdirs)
        raw_rgb, raw_sigma = self._run_mlp(mlp, points[:, None, :], viewdirs_enc)
        return raw_rgb[:, 0], raw_sigma[:, 0]

    def eval_points(self, points: torch.Tensor, viewdirs: Optional[torch.Tensor] = None,
                    coarse: bool = False):
        """Decoded (rgb, sigma) at [B, 3] points (models.py:183-214)."""
        raw_rgb, raw_sigma = self.eval_points_raw(points, viewdirs, coarse)
        if self.sh_deg >= 0 or self.sg_dim > 0:
            if viewdirs is None:
                raise ValueError("SH/SG decode needs viewdirs")
            decoded = self._decode_radiance(raw_rgb[:, None, :], viewdirs)[:, 0]
        else:
            decoded = raw_rgb
        return self.rgb_activation(decoded), self.sigma_activation(raw_sigma)


def validate_activations(rgb_activation: Callable, sigma_activation: Callable) -> None:
    """Constructor-time activation range checks (models.py:366-385)."""
    x = torch.exp(torch.linspace(-90, 90, 1024))
    x = torch.cat([-x.flip(0), x], 0)
    rgb = rgb_activation(x)
    if bool((rgb < 0).any()) or bool((rgb > 1).any()):
        raise ValueError("rgb_activation produces colors outside [0, 1]")
    if bool((sigma_activation(x) < 0).any()):
        raise ValueError("sigma_activation produces negative densities")


# ---------------------------------------------------------------------------
# Weight carry
# ---------------------------------------------------------------------------

def _to_np_tree(d):
    if isinstance(d, Mapping):
        return {k: _to_np_tree(v) for k, v in d.items()}
    return np.asarray(d)


def nerf_sh_params_from_jaxnerf(ckpt_params: Mapping) -> Dict[str, Any]:
    """jaxnerf / PlenOctree flax checkpoint params -> NeRFSHModel params (a
    copy of ``nerf_projects_tpu/utils/interop.py::nerf_sh_params_from_jaxnerf``).

    The reference checkpoint tree is {params: {MLP_0: {Dense_i: ...},
    MLP_1: {...}[, sg_lambda, sg_mu_spher]}}; the CondMLP numbers its Dense
    layers in the same call order, so the mapping renames MLP_0 ->
    mlp_coarse and MLP_1 -> mlp_fine.
    """
    src = ckpt_params.get("params", ckpt_params)
    out: Dict[str, Any] = {}
    if "MLP_0" in src:
        out["mlp_coarse"] = _to_np_tree(src["MLP_0"])
    if "MLP_1" in src:
        out["mlp_fine"] = _to_np_tree(src["MLP_1"])
    for extra in ("sg_lambda", "sg_mu_spher"):
        if extra in src:
            out[extra] = np.asarray(src[extra])
    return {"params": out}


def cond_mlp_flax_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax CondMLP parameter tree ({Dense_i: {kernel, bias}}, under
    "params" or not) of numpy arrays -> the port's CondMLP state dict.
    Flax kernels are [in, out]; ``nn.Linear`` weights are [out, in]."""
    p = tree.get("params", tree)
    state = {}
    for layer, leaf in p.items():
        i = int(layer.split("_")[1])
        state[f"dense.{i}.weight"] = torch.tensor(np.asarray(leaf["kernel"], np.float32).T)
        state[f"dense.{i}.bias"] = torch.tensor(np.asarray(leaf["bias"], np.float32))
    return state


def nerf_sh_flax_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A NeRFSHModel flax parameter tree of numpy arrays ({params:
    {mlp_coarse, mlp_fine, [sg_lambda, sg_mu_spher]}}), or a jaxnerf /
    PlenOctree one ({MLP_0, MLP_1}), -> the port's NeRFSHModel state dict."""
    p = tree.get("params", tree)
    if "MLP_0" in p:
        p = nerf_sh_params_from_jaxnerf(tree)["params"]
    state = {}
    for name, value in p.items():
        if name in ("mlp_coarse", "mlp_fine"):
            state.update({f"{name}.{k}": v for k, v in cond_mlp_flax_to_state_dict(value).items()})
        else:
            state[name] = torch.tensor(np.asarray(value, np.float32))
    return state
