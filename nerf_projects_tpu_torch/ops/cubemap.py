"""Cubemap direction and texel maths (port of
``nerf_projects_tpu/ops/cubemap.py``; svox2's cubemap_util).

The reference keeps this maths as a python mirror (svox2/utils.py:166-369)
and a CUDA header (csrc/include/cubemap_util.cuh) whose only user is
commented out; its live background samples an equirect grid
(``ops/background.py``). The module is there for component parity and for
cubemap environment data. Faces f = 2 * dominant axis + (component >= 0);
u runs along axis (ax ^ 1) & 1, v along (ax ^ 2) & 2, as the reference,
so face images are interchangeable. Equi-angular cubemaps (EAC) as the
reference. Modes "nearest" and "linear" (per-face clamped bilinear, the
reference python's ``linear_simple``).
"""
from __future__ import annotations

import math

import torch

from nerf_projects_tpu_torch.core.device import device_constant

_U_AXIS = (1, 0, 1)  # (ax ^ 1) & 1 for ax = 0, 1, 2
_V_AXIS = (2, 2, 0)  # (ax ^ 2) & 2


def dir_to_cubemap_coord(dirs: torch.Tensor, face_reso: int, eac: bool = True):
    """Directions [..., 3] (not necessarily unit) -> (face, u, v): u, v
    continuous texel coordinates in [-0.5, face_reso - 0.5], integers at
    texel centres (u = ((u_eac + 1) R - 1) / 2)."""
    ax = torch.argmax(torch.abs(dirs), dim=-1)
    maxv = torch.gather(dirs, -1, ax[..., None])[..., 0]
    scaled = dirs / torch.abs(maxv)[..., None]
    if eac:
        scaled = torch.atan(scaled) * (4.0 / math.pi)
    u_ax = device_constant(_U_AXIS, torch.int64, dirs.device)[ax]
    v_ax = device_constant(_V_AXIS, torch.int64, dirs.device)[ax]
    ue = torch.gather(scaled, -1, u_ax[..., None])[..., 0]
    ve = torch.gather(scaled, -1, v_ax[..., None])[..., 0]
    face = ax.to(torch.int32) * 2 + (maxv >= 0).to(torch.int32)
    return face, ((ue + 1.0) * face_reso - 1.0) * 0.5, ((ve + 1.0) * face_reso - 1.0) * 0.5


def cubemap_sample(cubemap: torch.Tensor, dirs: torch.Tensor, *, eac: bool = True,
                   mode: str = "linear") -> torch.Tensor:
    """Sample a [6, R, R, C] cubemap at directions [..., 3] -> [..., C]."""
    R = cubemap.shape[1]
    face, u, v = dir_to_cubemap_coord(dirs, R, eac=eac)
    face = face.long()
    if mode == "nearest":
        ui = torch.clamp(torch.floor(u + 0.5).to(torch.int64), 0, R - 1)
        vi = torch.clamp(torch.floor(v + 0.5).to(torch.int64), 0, R - 1)
        return cubemap[face, ui, vi]
    if mode != "linear":
        raise ValueError(f"unknown cubemap sample mode: {mode}")
    uc = torch.clamp(u, 0.0, R - 1.0)
    vc = torch.clamp(v, 0.0, R - 1.0)
    u0 = torch.clamp(torch.floor(uc).to(torch.int64), 0, R - 2)
    v0 = torch.clamp(torch.floor(vc).to(torch.int64), 0, R - 2)
    du = (uc - u0)[..., None]
    dv = (vc - v0)[..., None]
    r0 = cubemap[face, u0, v0] * (1 - dv) + cubemap[face, u0, v0 + 1] * dv
    r1 = cubemap[face, u0 + 1, v0] * (1 - dv) + cubemap[face, u0 + 1, v0 + 1] * dv
    return r0 * (1 - du) + r1 * du


def cubemap_coord_to_dir(face: torch.Tensor, u: torch.Tensor, v: torch.Tensor, face_reso: int,
                         eac: bool = True) -> torch.Tensor:
    """The inverse of ``dir_to_cubemap_coord``: unit-cube directions
    (|max component| = 1) [..., 3]."""
    ue = (u * 2.0 + 1.0) / face_reso - 1.0
    ve = (v * 2.0 + 1.0) / face_reso - 1.0
    if eac:
        ue = torch.tan(ue * (math.pi / 4.0))
        ve = torch.tan(ve * (math.pi / 4.0))
    face = face.long()
    ax = face // 2
    sign = (face % 2).to(torch.float32) * 2.0 - 1.0
    u_ax = device_constant(_U_AXIS, torch.int64, face.device)[ax]
    v_ax = device_constant(_V_AXIS, torch.int64, face.device)[ax]
    idx = torch.arange(3, device=face.device)
    return (torch.where(idx == ax[..., None], sign[..., None], 0.0)
            + torch.where(idx == u_ax[..., None], ue[..., None], 0.0)
            + torch.where(idx == v_ax[..., None], ve[..., None], 0.0))
