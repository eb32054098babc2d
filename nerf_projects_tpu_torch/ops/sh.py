"""Real spherical-harmonic basis evaluation, degrees 0-4 (port of
``nerf_projects_tpu/ops/sh.py``: ``eval_sh_bases``, ``eval_sh`` and the SH
projections of a view-dependent function).

The constants are the standard real-SH normalisation factors that the
reference's three SH implementations hardcode (svox2/svox2/utils.py
``eval_sh_bases``, plenoctree/nerf_sh/nerf/sh.py ``eval_sh``).
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)

MAX_SH_DEGREE = 4


def eval_sh_bases(basis_dim: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis values [..., basis_dim] at unit directions [..., 3];
    basis_dim in 1..25 (non-square dims truncate the last band, as
    svox2 allows)."""
    if not (1 <= basis_dim <= 25):
        raise ValueError(f"basis_dim must be in [1, 25], got {basis_dim}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, SH_C0)]
    if basis_dim > 1:
        comps += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if basis_dim > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if basis_dim > 9:
        comps += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if basis_dim > 16:
        comps += [
            SH_C4[0] * xy * (xx - yy),
            SH_C4[1] * yz * (3.0 * xx - yy),
            SH_C4[2] * xy * (7.0 * zz - 1.0),
            SH_C4[3] * yz * (7.0 * zz - 3.0),
            SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            SH_C4[5] * xz * (7.0 * zz - 3.0),
            SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            SH_C4[7] * xz * (xx - 3.0 * yy),
            SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(comps[:basis_dim], dim=-1)


def eval_sh(deg: int, sh_coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Decode [..., C, (deg+1)^2] coefficients at unit directions
    [..., 3] -> [..., C] (raw; the caller applies the activation)."""
    basis_dim = (deg + 1) ** 2
    if sh_coeffs.shape[-1] != basis_dim:
        raise ValueError(
            f"expected trailing dim {basis_dim} for deg {deg}, got {sh_coeffs.shape[-1]}"
        )
    basis = eval_sh_bases(basis_dim, dirs)
    return torch.sum(sh_coeffs * basis[..., None, :], dim=-1)


# ---------------------------------------------------------------------------
# SH projection of a view-dependent radiance function
# (parity: octree/nerf/sh_proj.py:241-346)
# ---------------------------------------------------------------------------

def spherical_uniform_dirs(n: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """n area-uniform unit directions [n, 3], drawn from ``generator`` on
    ``device`` (the generator's device when None)."""
    dev = generator.device if device is None else torch.device(device)
    u = torch.rand((n, 2), generator=generator, device=dev)
    z = 1.0 - 2.0 * u[:, 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * torch.pi * u[:, 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def project_function_sh(fn_vals: torch.Tensor, dirs: torch.Tensor, deg: int) -> torch.Tensor:
    """Monte-Carlo SH projection: function samples [N_pts, N_dirs, C] at
    uniform unit directions [N_dirs, 3] -> coefficients [N_pts, C,
    (deg+1)^2], with the 4 pi / N_dirs weight (sh_proj.py:278-306)."""
    basis = eval_sh_bases((deg + 1) ** 2, dirs)  # [D, B]
    weight = 4.0 * torch.pi / dirs.shape[0]
    return weight * torch.einsum("ndc,db->ncb", fn_vals, basis)


def project_function_sh_lstsq(fn_vals: torch.Tensor, dirs: torch.Tensor, deg: int) -> torch.Tensor:
    """Least-squares SH projection (sh_proj.py:308-346 variant): the
    coefficients that fit basis @ coeffs to the samples per point and
    channel, through the pseudo-inverse of the Gram matrix."""
    basis = eval_sh_bases((deg + 1) ** 2, dirs)  # [D, B]
    gram_inv = torch.linalg.pinv(basis.T @ basis)  # [B, B]
    return torch.einsum("ndc,db,be->nce", fn_vals, basis, gram_inv)
