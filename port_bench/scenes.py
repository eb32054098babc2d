"""Inputs the benchmark makes from the seed: cameras and rays, brick
occupancy, grid cells, NeRF weights and the analytic training targets.

Frozen copies of the scene builders of ``chip_smoke.py`` (``frame_tiles``,
``random_cells``, ``shell_select``, ``scene_grid``, ``train_grid``) and of
the ray and tiling arithmetic the port's helpers compute
(``core/rays.py``, ``ops/tile_render.py``, ``ops/brick_grid.py``), so that
no input is made by the code under test. Nothing here imports the port:
the plain references build their inputs from the same functions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BRICK = 8


def sub_seed(seed: int, tag: int) -> int:
    """A seed of its own for each input, from the run's seed."""
    return (int(seed) * 1_000_003 + int(tag)) % (2**63)


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------

def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world [4, 4] on a sphere looking at the origin, angles in
    degrees (nerf/load_blender.py:29)."""
    def rot_phi(p):
        c, s = np.cos(p), np.sin(p)
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float64)

    def rot_theta(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float64)

    c2w = np.eye(4)
    c2w[2, 3] = radius
    c2w = rot_theta(theta / 180.0 * np.pi) @ rot_phi(phi / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)
    return (flip @ c2w).astype(np.float32)


def blender_rays(height: int, width: int, focal: float, c2w, device):
    """OpenGL pinhole rays of a Blender camera (pixel centres at integer
    indices, as the reference's get_rays): origins, directions (not unit)
    and unit viewdirs, each [H * W, 3] float32."""
    c2w = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=device)
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    y, x = torch.meshgrid(y, x, indexing="ij")
    cam = torch.stack([(x - 0.5 * width) / focal, -(y - 0.5 * height) / focal, -torch.ones_like(x)], dim=-1)
    d = (cam @ c2w[:3, :3].T).reshape(-1, 3)
    o = c2w[:3, 3].expand(d.shape).contiguous()
    return o, d, d / torch.linalg.norm(d, dim=-1, keepdim=True)


def opencv_rays(height: int, width: int, focal: float, c2w, device):
    """OpenCV pinhole rays (+z forward, pixel centres at +0.5), unit
    directions: origins, directions, each [H * W, 3] (svox2's gen_rays)."""
    c2w = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=device)
    x = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    y, x = torch.meshgrid(y, x, indexing="ij")
    cam = torch.stack([(x - 0.5 * width) / focal, (y - 0.5 * height) / focal, torch.ones_like(x)], dim=-1)
    cam = cam / torch.linalg.norm(cam, dim=-1, keepdim=True)
    d = (cam @ c2w[:3, :3].T).reshape(-1, 3)
    return c2w[:3, 3].expand(d.shape).contiguous(), d.contiguous()


def orbit_pose(i: int, radius: float, step_rad: float) -> np.ndarray:
    """chip_smoke.py's frame_tiles(i) camera: on a circle of ``radius``
    in the xz plane, ``step_rad`` apart, axes as the identity's."""
    pose = np.eye(4, dtype=np.float32)
    ang = step_rad * i
    pose[0, 3] = radius * np.sin(ang)
    pose[2, 3] = -radius * np.cos(ang)
    return pose


def to_tiles(x: torch.Tensor, height: int, width: int, th: int, tw: int) -> torch.Tensor:
    """Row-major image rows [H * W, C] -> coherent tiles [T, th * tw, C]."""
    c = x.shape[-1]
    x = x.reshape(height // th, th, width // tw, tw, c)
    return x.permute(0, 2, 1, 3, 4).reshape(-1, th * tw, c)


# ---------------------------------------------------------------------------
# Brick occupancy and cells
# ---------------------------------------------------------------------------

def channels(basis_dim: int) -> int:
    """Channels a cell holds in the march's cell array: 1 + 3B padded to 8."""
    return -(-(1 + 3 * basis_dim) // 8) * 8


def sphere_bricks(reso: int):
    """The bricks of a reso^3 grid that the sphere bound keeps (a brick
    is kept when its point closest to the centre lies in the unit sphere
    grown by half a voxel diagonal): bool [B, B, B] (numpy)."""
    n = reso // BRICK
    rs = float(reso)
    thresh2 = (1.0 + math.sqrt(3.0) * (2.0 / rs) * 0.5) ** 2
    idx = np.stack(np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij"), -1)
    lo = (idx * BRICK + 0.5) / rs * 2.0 - 1.0
    hi = (idx * BRICK + BRICK - 0.5) / rs * 2.0 - 1.0
    closest = np.clip(0.0, lo, hi)
    return (closest**2).sum(-1) <= thresh2


def shell_bricks(reso: int, r_lo: float, r_hi: float):
    """The sphere's bricks whose centre lies at radius r_lo..r_hi of the
    unit sphere (chip_smoke.py's shell_select)."""
    active = sphere_bricks(reso)
    idx = np.stack(np.meshgrid(*(np.arange(reso // BRICK),) * 3, indexing="ij"), -1)
    rad = np.linalg.norm((idx * 8.0 + 4.0) / reso * 2.0 - 1.0, axis=-1)
    return active & (rad >= r_lo) & (rad <= r_hi)


def brick_geometry(active: np.ndarray, reso: int, device):
    """(brick_links int32 [B, B, B], brick_coords int32 [nb, 3], cell_mask
    bool [nb, 512]) of the active bricks, rows in x-major order; a cell is
    active when its centre lies in the bound of ``sphere_bricks``."""
    links = np.full(active.shape, -1, np.int32)
    nb = int(active.sum())
    links[active] = np.arange(nb, dtype=np.int32)
    coords = torch.from_numpy(np.argwhere(active).astype(np.int32)).to(device)
    off = torch.arange(BRICK**3, dtype=torch.int32, device=device)
    local = torch.stack([off // (BRICK * BRICK), (off // BRICK) % BRICK, off % BRICK], dim=-1)
    cell = coords[:, None, :] * BRICK + local[None]
    c = (cell.float() + 0.5) / float(reso) * 2.0 - 1.0
    thresh2 = (1.0 + math.sqrt(3.0) * (2.0 / reso) * 0.5) ** 2
    mask = torch.sum(c * c, dim=-1) <= thresh2
    return torch.from_numpy(links).to(device), coords, mask


def random_cells(cell_mask: torch.Tensor, basis_dim: int, gen: torch.Generator, opaque_sigma=None,
                 chunk: int = 8192) -> torch.Tensor:
    """The march's bf16 cell array [nb, 512, CP] filled from ``gen``:
    density U[0, 2] (or U[S/2, 3S/2] with opaque_sigma=S) and SH N(0,
    0.2^2) on active cells, zeros elsewhere (chip_smoke.py's
    random_cells). The values are bf16 numbers: both sides read them."""
    nb = cell_mask.shape[0]
    B = basis_dim
    cells = torch.zeros((nb, BRICK**3, channels(B)), dtype=torch.bfloat16, device=cell_mask.device)
    for i in range(0, nb, chunk):
        m = cell_mask[i:i + chunk].float()
        d = torch.rand(m.shape, generator=gen, device=m.device) * 2.0
        if opaque_sigma is not None:
            d = d * (opaque_sigma / 2.0) + opaque_sigma / 2.0
        cells[i:i + chunk, :, 0] = d * m
        sh = torch.randn(m.shape + (3 * B,), generator=gen, device=m.device) * 0.2
        cells[i:i + chunk, :, 1:1 + 3 * B] = sh * m[..., None]
    return cells


def random_masters(cell_mask: torch.Tensor, basis_dim: int, gen: torch.Generator, chunk: int = 8192):
    """Float32 masters (density [nb, 512] U[0, 2], SH [nb, 512, 3B] N(0,
    0.2^2) on active cells; chip_smoke.py's train_grid)."""
    nb = cell_mask.shape[0]
    dev = cell_mask.device
    dens = torch.empty((nb, BRICK**3), device=dev)
    sh = torch.empty((nb, BRICK**3, 3 * basis_dim), device=dev)
    for i in range(0, nb, chunk):
        m = cell_mask[i:i + chunk].float()
        dens[i:i + chunk] = torch.rand(m.shape, generator=gen, device=dev) * 2.0 * m
        sh[i:i + chunk] = torch.randn(m.shape + (3 * basis_dim,), generator=gen, device=dev) * 0.2 * m[..., None]
    return dens, sh


# ---------------------------------------------------------------------------
# NeRF weights and targets
# ---------------------------------------------------------------------------

def nerf_shapes(depth: int, width: int, in_ch: int, in_ch_views: int, skips=(4,)) -> list:
    """(name, [out, in]) of each nn.Linear weight of the viewdirs NeRF MLP,
    in the port's parameter order, with each bias after its weight."""
    fan_in = [in_ch] + [width + (in_ch if i in skips else 0) for i in range(depth - 1)]
    layers = [(f"trunk.{i}", width, f) for i, f in enumerate(fan_in)]
    layers += [("sigma_head", 1, width), ("bottleneck", width, width), ("view_0", width // 2, width + in_ch_views),
               ("rgb_head", 3, width // 2)]
    out = []
    for name, o, i in layers:
        out += [(f"{name}.weight", (o, i)), (f"{name}.bias", (o,))]
    return out


def nerf_weights(shapes: list, gen: torch.Generator, bias_std: float, device) -> dict:
    """One model's float32 parameters from ``gen`` in two large draws:
    weights lecun-normal truncated at two standard deviations (flax's
    Dense init) and biases N(0, bias_std^2) (a trained model's biases are
    not zero, so the check sees where each is read)."""
    n_w = sum(int(np.prod(s)) for n, s in shapes if n.endswith("weight"))
    n_b = sum(int(np.prod(s)) for n, s in shapes if n.endswith("bias"))
    w = torch.randn(n_w, generator=gen, device=device).clamp_(-2.0, 2.0) / 0.87962566103423978
    b = torch.randn(n_b, generator=gen, device=device) * bias_std
    out, aw, ab = {}, 0, 0
    for name, s in shapes:
        k = int(np.prod(s))
        if name.endswith("weight"):
            out[name] = (w[aw:aw + k] * math.sqrt(1.0 / s[1])).reshape(s)
            aw += k
        else:
            out[name] = b[ab:ab + k].reshape(s).clone()
            ab += k
    return out


def set_density_logits(p: dict, mlp, depth: int, gen: torch.Generator, mean: float, std: float,
                       n_points: int = 8192, box: float = 2.0) -> dict:
    """Scale and shift the sigma head of a random model ``p`` so that its
    density logit over points uniform in [-box, box]^3 (random unit views)
    has this mean and standard deviation. A random MLP's logit barely
    varies over space (std ~0.1 about a seed-dependent offset), so its
    scene is empty or all opaque at the far plane's 1e10 tail; a trained
    model's spans tens of units between empty space and surfaces.
    ``mlp(p, x_enc, v_enc, depth)`` is the plain forward (rgb, sigma)."""
    dev = p["sigma_head.bias"].device
    pts = (torch.rand((n_points, 3), generator=gen, device=dev) * 2.0 - 1.0) * box
    views = torch.randn((n_points, 3), generator=gen, device=dev)
    views = views / torch.linalg.norm(views, dim=-1, keepdim=True)
    with torch.no_grad():
        _, sig = mlp(p, pts, views, depth)
        mu, sd = float(sig.mean()), float(sig.std())
    k = std / max(sd, 1e-6)
    p["sigma_head.weight"] = p["sigma_head.weight"] * k
    p["sigma_head.bias"] = (p["sigma_head.bias"] - mu) * k + mean
    return p


def sphere_colors(origins: torch.Tensor, dirs: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """The analytic scene the training pools show: a sphere of ``radius``
    at the origin coloured by its normal (0.5 + 0.5 n), white elsewhere."""
    d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    b = (origins * d).sum(-1)
    c = (origins * origins).sum(-1) - radius * radius
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    hit = (disc > 0) & (t > 0)
    n = (origins + t[:, None] * d) / radius
    return torch.where(hit[:, None], 0.5 + 0.5 * n, torch.ones_like(n)).clamp(0.0, 1.0)


def view_angles(n_views: int, gen_seed: int):
    """(theta, phi) degrees of n_views cameras on the upper hemisphere,
    drawn from the seed as the Blender set's train views are spread."""
    rng = np.random.default_rng(gen_seed)
    return rng.uniform(0.0, 360.0, n_views), rng.uniform(-90.0, -5.0, n_views)
