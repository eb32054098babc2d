"""Background models for unbounded scenes (port of
``nerf_projects_tpu/ops/background.py``).

svox2's optional background (svox2.py:497-521, render_lerp_kernel_cuvol
.cu:386-611) is a stack of concentric spheres outside the foreground
grid, each holding RGBA, composited behind the grid with the
transmittance the grid leaves. Two forms:

  * ``BackgroundMSI``: the JAX package's trainable form, one
    equirectangular [H, W, 4] panorama a layer (rgb logits and density),
    sampled bilinearly, at radii r_i = inner / (1 - i/n);
  * ``ReferenceBackground``: svox2's own storage, as its npz checkpoints
    carry it (``links`` [2 reso, reso] into ``data`` [cap, nlayers, 4],
    rgb as SH-DC), rendered by the reference's MSI march
    (svox2.py:796-883).

The JAX package's ``lax.scan`` over layers or shells is a Python loop
here. Nothing copies host numbers to the device after a model's first
use: radii, centres and the like are device constants.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import device_constant, resolve_device
from nerf_projects_tpu_torch.ops.grid import gather_rows

SH_C0 = 0.28209479177387814


class BackgroundMSI(NamedTuple):
    """Equirect multi-sphere image: data [nlayers, H, W, 4] (rgb logits
    and density) on the device, radii float32 [nlayers] (host numpy,
    world units, increasing)."""

    data: torch.Tensor
    radii: np.ndarray

    @staticmethod
    def create(nlayers: int = 16, reso: int = 128, *, inner_radius: float = 1.0, init_density: float = 0.1,
               device: Optional[Union[str, torch.device]] = None) -> "BackgroundMSI":
        """Layers at inverse-depth spacing r_i = inner / (1 - i/n), the
        last near n * inner; data zero but for the density,
        ``init_density``."""
        i = np.arange(nlayers, dtype=np.float64)
        radii = inner_radius / (1.0 - i / nlayers)
        data = torch.zeros((nlayers, reso, 2 * reso, 4), dtype=torch.float32, device=resolve_device(device))
        if init_density:
            data[..., 3].fill_(init_density)
        return BackgroundMSI(data=data, radii=radii.astype(np.float32))

    @staticmethod
    def from_numpy(data, radii, device: Optional[Union[str, torch.device]] = None) -> "BackgroundMSI":
        """From host arrays (e.g. a JAX package BackgroundMSI's fields)."""
        return BackgroundMSI(data=torch.from_numpy(np.array(data, np.float32)).to(resolve_device(device)),
                             radii=np.asarray(radii, np.float32).copy())


def _equirect_uv(dirs: torch.Tensor):
    """Unit directions [..., 3] -> (u, v) in [0, 1): longitude, latitude."""
    lon = torch.atan2(dirs[..., 0], -dirs[..., 2])
    lat = torch.asin(torch.clamp(dirs[..., 1], -1.0, 1.0))
    return lon / (2 * math.pi) + 0.5, 0.5 - lat / math.pi


def sample_equirect(img: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear panorama sample of img [H, W, C] at unit directions
    [..., 3] -> [..., C]; the longitude wraps, the latitude clamps."""
    H, W = img.shape[:2]
    u, v = _equirect_uv(dirs)
    x = u * W - 0.5
    y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0w = torch.remainder(x0, W)
    x1w = torch.remainder(x0 + 1, W)
    flat = img.reshape((H * W,) + img.shape[2:])  # gathered by index_select: its backward adds without sorting
    c00 = gather_rows(flat, y0 * W + x0w)
    c01 = gather_rows(flat, y0 * W + x1w)
    c10 = gather_rows(flat, (y0 + 1) * W + x0w)
    c11 = gather_rows(flat, (y0 + 1) * W + x1w)
    return c00 * (1 - wx) * (1 - wy) + c01 * wx * (1 - wy) + c10 * (1 - wx) * wy + c11 * wx * wy


def _sphere_exit_t(origins, dirs, radius):
    """t of the far intersection of |o + t d| = radius (rays start inside
    the sphere, as MSI rays do)."""
    a = torch.sum(dirs * dirs, dim=-1)
    b = 2.0 * torch.sum(origins * dirs, dim=-1)
    c = torch.sum(origins * origins, dim=-1) - radius**2
    disc = torch.clamp(b * b - 4 * a * c, min=0.0)
    return (-b + torch.sqrt(disc)) / (2.0 * a)


def render_background(msi: BackgroundMSI, origins: torch.Tensor, dirs: torch.Tensor, transmittance: torch.Tensor, *,
                      background_brightness: float = 1.0) -> torch.Tensor:
    """The MSI behind the foreground: world rays [R, 3], the transmittance
    [R] the foreground leaves -> the rgb it adds [R, 3], already scaled by
    that transmittance, the solid ``background_brightness`` behind the
    last layer included."""
    world_len = torch.linalg.norm(dirs, dim=-1)
    radii = device_constant(msi.radii, torch.float32, origins.device)
    log_T = torch.log(torch.clamp(transmittance, min=1e-10))
    rgb_acc = torch.zeros(origins.shape[:1] + (3,), dtype=origins.dtype, device=origins.device)
    prev_t = torch.zeros(origins.shape[:1], dtype=origins.dtype, device=origins.device)
    for i in range(msi.data.shape[0]):
        t = _sphere_exit_t(origins, dirs, radii[i])
        pts = origins + t[:, None] * dirs
        pdirs = pts / torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), min=1e-9)
        vals = sample_equirect(msi.data[i], pdirs)  # [R, 4]
        rgb = torch.sigmoid(vals[:, :3])
        sigma = torch.relu(vals[:, 3])
        tau = sigma * torch.clamp(t - prev_t, min=0.0) * world_len
        w = torch.exp(log_T) * (1.0 - torch.exp(-tau))
        log_T, rgb_acc, prev_t = log_T - tau, rgb_acc + w[:, None] * rgb, t
    return rgb_acc + torch.exp(log_T)[:, None] * background_brightness


# ---------------------------------------------------------------------------
# svox2's checkpoint layout
# ---------------------------------------------------------------------------


class ReferenceBackground(NamedTuple):
    """svox2's background as its npz checkpoints store it (svox2.py:497-521,
    1546-1548): ``links`` int32 [2 reso (longitude), reso (latitude)]
    into the rows of ``data`` [cap, nlayers, 4] (rgb as SH-DC logits,
    density); a link of -1 is a pruned texel."""

    data: torch.Tensor
    links: torch.Tensor

    @property
    def nlayers(self) -> int:
        return self.data.shape[1]

    @property
    def reso(self) -> int:
        return self.links.shape[1]

    @staticmethod
    def from_numpy(data, links, device: Optional[Union[str, torch.device]] = None) -> "ReferenceBackground":
        dev = resolve_device(device)
        return ReferenceBackground(data=torch.from_numpy(np.array(data, np.float32)).to(dev),
                                   links=torch.from_numpy(np.array(links, np.int32)).to(dev))


def xyz2equirect(dirs: torch.Tensor, reso: int) -> torch.Tensor:
    """Unit directions [..., 3] -> equirect pixel coordinates [..., 2] in
    svox2's convention (utils.py:599-609): x = 2 reso (0.5 + atan2(dx,
    dz) / 2pi) in [0, 2 reso], y = reso (0.5 - asin(dy) / pi) in
    [0, reso]."""
    lat = torch.asin(torch.clamp(dirs[..., 1], -1.0, 1.0))
    lon = torch.atan2(dirs[..., 0], dirs[..., 2])
    return torch.stack([reso * 2 * (0.5 + lon / (2 * math.pi)), reso * (0.5 - lat / math.pi)], dim=-1)


def equirect2xyz(xy: torch.Tensor, reso: int) -> torch.Tensor:
    """The inverse of ``xyz2equirect`` (unit directions)."""
    lon = (xy[..., 0] / (2 * reso) - 0.5) * (2 * math.pi)
    lat = (0.5 - xy[..., 1] / reso) * math.pi
    cl = torch.cos(lat)
    return torch.stack([cl * torch.sin(lon), torch.sin(lat), cl * torch.cos(lon)], dim=-1)


def _fetch_bg(bg: ReferenceBackground, lx, ly, lz):
    """A texel's row through the links; pruned texels read 0
    (svox2.py:809)."""
    lnk = bg.links[lx, ly]
    vals = bg.data[torch.clamp(lnk, min=0).long(), lz]
    return torch.where((lnk >= 0)[..., None], vals, 0.0)


def sample_reference_background(bg: ReferenceBackground, sphdirs: torch.Tensor, invr: torch.Tensor) -> torch.Tensor:
    """Trilinear (longitude, latitude, layer) sample at unit sphere
    points [..., 3] and inverse radii [...] -> [..., 4], as the
    reference's python path (svox2.py:833-866): x wraps mod 2 reso, y
    mod reso, the layer z = (1 - invr) nlayers - 0.5 is clamped."""
    n_layers, reso = bg.nlayers, bg.reso
    xy = xyz2equirect(sphdirs, reso)
    z = torch.clamp((1.0 - invr) * n_layers - 0.5, 0.0, n_layers - 1.0)
    pts = torch.cat([xy, z[..., None]], dim=-1)
    top = device_constant((2 * reso - 1, reso - 1, n_layers - 2), torch.int64, pts.device)
    l = torch.minimum(torch.floor(pts).to(torch.int64), top)
    wb = pts - l
    wa = 1.0 - wb
    lx, ly, lz = l[..., 0], l[..., 1], l[..., 2]
    lnx = torch.remainder(lx + 1, 2 * reso)
    lny = torch.remainder(ly + 1, reso)
    lnz = lz + 1
    c00 = _fetch_bg(bg, lx, ly, lz) * wa[..., 2:] + _fetch_bg(bg, lx, ly, lnz) * wb[..., 2:]
    c01 = _fetch_bg(bg, lx, lny, lz) * wa[..., 2:] + _fetch_bg(bg, lx, lny, lnz) * wb[..., 2:]
    c10 = _fetch_bg(bg, lnx, ly, lz) * wa[..., 2:] + _fetch_bg(bg, lnx, ly, lnz) * wb[..., 2:]
    c11 = _fetch_bg(bg, lnx, lny, lz) * wa[..., 2:] + _fetch_bg(bg, lnx, lny, lnz) * wb[..., 2:]
    c0 = c00 * wa[..., 1:2] + c01 * wb[..., 1:2]
    c1 = c10 * wa[..., 1:2] + c11 * wb[..., 1:2]
    return c0 * wa[..., :1] + c1 * wb[..., :1]


def render_background_reference(bg: ReferenceBackground, origins: torch.Tensor, dirs: torch.Tensor,
                                transmittance: torch.Tensor, *, radius, center, step_size: float = 0.5,
                                background_brightness: float = 1.0) -> torch.Tensor:
    """The reference's MSI composite for svox2 checkpoints (its python
    path, svox2.py:796-883): rays in the normalised sphere frame ((o -
    center) / radius, the foreground box inscribed in the unit sphere),
    marched over n_steps = nlayers / step_size + 2 shells at
    r_i = n / (n - i - 0.5) from outside each ray's inner radius
    max(|o x d|, 1); each segment trilerps (longitude, latitude, inverse
    radius), decodes rgb as SH-DC (c C0 + 0.5, clamped at 0) and
    attenuates by exp(-world_step relu(sigma) dt). World rays [R, 3]
    (unit dirs), the foreground's leftover transmittance [R] -> the rgb
    it adds [R, 3], the solid ``background_brightness`` included."""
    dev = origins.device
    radius = device_constant(np.broadcast_to(np.asarray(radius, np.float32), (3,)), torch.float32, dev)
    center = device_constant(np.asarray(center, np.float32), torch.float32, dev)
    o_n = (origins - center) / radius
    d_s = dirs / radius
    inorm = 1.0 / torch.linalg.norm(d_s, dim=-1)
    d_n = d_s * inorm[..., None]
    world_step = inorm  # the normalised frame's dt in world length

    n_steps = int(bg.nlayers / step_size) + 2
    inner_radius = torch.clamp(torch.linalg.norm(torch.linalg.cross(o_n, d_n, dim=-1), dim=-1) + 1e-3, min=1.0)
    qb = torch.sum(o_n * d_n, dim=-1)
    c0 = torch.sum(o_n * o_n, dim=-1)

    def far_t(r):
        det = qb * qb - (c0 - r * r)
        ok = det >= 0
        return ok, torch.where(ok, -qb + torch.sqrt(torch.clamp(det, min=0.0)), 0.0)

    _, t_last = far_t(inner_radius)
    log_T = torch.log(torch.clamp(transmittance, min=1e-10))
    rgb_acc = torch.zeros(origins.shape[:-1] + (3,), dtype=origins.dtype, device=dev)
    for i in range(n_steps):
        r = float(np.float32(n_steps) / (np.float32(n_steps) - np.float32(i) - np.float32(0.5)))  # float32, as JAX
        ok, t = far_t(r)
        active = ok & (r >= inner_radius)
        t_mid = (t + t_last) * 0.5
        sphpos = o_n + t_mid[..., None] * d_n
        invr_mid = 1.0 / torch.clamp(torch.linalg.norm(sphpos, dim=-1), min=1e-9)
        rgba = sample_reference_background(bg, sphpos * invr_mid[..., None], invr_mid)
        log_att = -world_step * torch.relu(rgba[..., 3]) * torch.clamp(t - t_last, min=0.0)
        weight = torch.where(active, torch.exp(log_T) * (1.0 - torch.exp(log_att)), 0.0)
        rgb_acc = rgb_acc + weight[..., None] * torch.clamp(rgba[..., :3] * SH_C0 + 0.5, min=0.0)
        log_T = torch.where(active, log_T + log_att, log_T)
        t_last = torch.where(active, t, t_last)
    return rgb_acc + torch.exp(log_T)[..., None] * background_brightness


def reference_to_msi(bg: ReferenceBackground, radius=None) -> BackgroundMSI:
    """A svox2 background resampled into a ``BackgroundMSI`` (to train
    on): each layer sampled at the MSI's texel-centre directions, rgb
    converted from SH-DC to sigmoid logits (clipped where the SH-DC
    decode saturates). ``radius`` is accepted as JAX's and unused."""
    del radius
    n_layers, reso = bg.nlayers, bg.reso
    H, W = reso, 2 * reso
    dev = bg.data.device
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    v = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    lon = (u - 0.5) * 2 * math.pi
    lat = (0.5 - v) * math.pi
    cl = torch.cos(lat)[:, None]
    dirs = torch.stack([cl * torch.sin(lon)[None, :], torch.sin(lat)[:, None].expand(H, W),
                        cl * (-torch.cos(lon))[None, :]], dim=-1)  # _equirect_uv's inverse: lon = atan2(x, -z)
    layers = []
    for i in range(n_layers):
        invr = torch.full((H * W,), 1.0 - (i + 0.5) / n_layers, dtype=torch.float32, device=dev)
        vals = sample_reference_background(bg, dirs.reshape(-1, 3), invr).reshape(H, W, 4)
        rgb01 = torch.clamp(vals[..., :3] * SH_C0 + 0.5, 1e-4, 1 - 1e-4)
        layers.append(torch.cat([torch.log(rgb01) - torch.log1p(-rgb01), vals[..., 3:]], dim=-1))
    i = np.arange(n_layers, dtype=np.float64)
    return BackgroundMSI(data=torch.stack(layers), radii=(1.0 / (1.0 - (i + 0.5) / n_layers)).astype(np.float32))


def load_reference_background(path: str, device: Optional[Union[str, torch.device]] = None):
    """The background arrays of a svox2 npz checkpoint (None if it has
    none), on ``device`` (None: the card)."""
    z = np.load(path)
    if "background_data" not in z:
        return None
    return ReferenceBackground.from_numpy(z["background_data"], z["background_links"], device=device)


def save_reference_background(path_dict: dict, bg: ReferenceBackground) -> None:
    """Add svox2's background keys to a dict of npz arrays."""
    path_dict["background_data"] = bg.data.detach().cpu().numpy().astype(np.float32)
    path_dict["background_links"] = bg.links.cpu().numpy().astype(np.int32)


def background_tv_loss(msi: BackgroundMSI) -> torch.Tensor:
    """Squared differences along each layer's latitude and longitude and
    across layers (inplace_tv_background_grad's loss, svox2.py:1930)."""
    d = msi.data
    return (torch.mean(torch.square(d[:, 1:] - d[:, :-1])) + torch.mean(torch.square(d[:, :, 1:] - d[:, :, :-1]))
            + torch.mean(torch.square(d[1:] - d[:-1])))
