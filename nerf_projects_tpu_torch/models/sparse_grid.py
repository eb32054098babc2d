"""Plenoxels sparse voxel grid, the svox2 ``SparseGrid`` equivalent (port
of ``nerf_projects_tpu/models/sparse_grid.py``).

Storage follows the svox2 npz schema (svox2/svox2/svox2.py:355-535,
1526-1628), so a grid saved by the JAX package loads here and the other
way round:
  * ``links``        int32 [X, Y, Z]: -1 = empty, else a row of the
    compact arrays;
  * ``density_data`` float32 [cap, 1];
  * ``sh_data``      float32 [cap, 3 * basis_dim] (float16 in the npz);
  * ``radius``, ``center`` float32 [3] (host numpy): the world box is
    center +- radius;
  * rows in Morton (z-)order for locality (svox2.py:415-418).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import device_constant, resolve_device


def morton_code_3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave the bits of three coordinate arrays (z-order, < 2^21)."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v

    return (spread(x) << np.uint64(2)) | (spread(y) << np.uint64(1)) | spread(z)


def _grid_transform(reso, radius, center, device):
    """(scale, offset, radius, center) tensors of the voxel-unit map
    g = (p - center) / radius * reso/2 + reso/2 - 0.5."""
    reso = device_constant(np.asarray(reso, np.float32), torch.float32, device)
    return (reso * 0.5, reso * 0.5 - 0.5,
            device_constant(np.asarray(radius, np.float32), torch.float32, device),
            device_constant(np.asarray(center, np.float32), torch.float32, device))


def world_to_grid(pts: torch.Tensor, reso, radius, center) -> torch.Tensor:
    """World [..., 3] -> continuous grid coordinates in voxel units:
    integer coordinates are the data sample locations (svox2)."""
    scale, offset, radius, center = _grid_transform(reso, radius, center, pts.device)
    return (pts - center) / radius * scale + offset


@dataclass
class SparseGrid:
    """A sparse voxel grid; the data tensors live on one device."""

    links: torch.Tensor         # int32 [X, Y, Z]
    density_data: torch.Tensor  # float32 [cap, 1]
    sh_data: torch.Tensor       # float32 [cap, 3 * basis_dim]
    radius: np.ndarray          # float32 [3]
    center: np.ndarray          # float32 [3]
    basis_dim: int = 9

    # -- constructors ------------------------------------------------------

    @staticmethod
    def create(
        reso,
        *,
        basis_dim: int = 9,
        radius=1.0,
        center=(0.0, 0.0, 0.0),
        use_sphere_bound: bool = False,
        use_z_order: bool = True,
        init_density: float = 0.1,
        init_sh: float = 0.0,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "SparseGrid":
        """Every voxel active, or those within the bounding sphere plus
        half a voxel diagonal (reference ctor svox2.py:420-447). The
        index is built on the host; at 512^3 that is GBs of numpy, so a
        large grid for rendering is built by ``ops.brick_grid
        .create_brick_grid`` instead."""
        dev = resolve_device(device)
        if isinstance(reso, int):
            reso = (reso, reso, reso)
        reso = tuple(int(r) for r in reso)
        radius = np.broadcast_to(np.asarray(radius, np.float32), (3,)).copy()
        center = np.asarray(center, np.float32).copy()

        X, Y, Z = reso
        ii, jj, kk = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij")
        if use_sphere_bound:
            cx = (ii + 0.5) / X * 2.0 - 1.0
            cy = (jj + 0.5) / Y * 2.0 - 1.0
            cz = (kk + 0.5) / Z * 2.0 - 1.0
            voxel_diag = np.linalg.norm([2.0 / X, 2.0 / Y, 2.0 / Z]) * 0.5
            active = (cx**2 + cy**2 + cz**2) <= (1.0 + voxel_diag) ** 2
        else:
            active = np.ones(reso, bool)

        n_active = int(active.sum())
        links = np.full(reso, -1, np.int32)
        act_idx = np.stack([ii[active], jj[active], kk[active]], -1)
        if use_z_order:
            order = np.argsort(morton_code_3d(act_idx[:, 0], act_idx[:, 1], act_idx[:, 2]))
            act_idx = act_idx[order]
        links[act_idx[:, 0], act_idx[:, 1], act_idx[:, 2]] = np.arange(n_active, dtype=np.int32)
        return SparseGrid(
            links=torch.from_numpy(links).to(dev),
            density_data=torch.full((n_active, 1), init_density, dtype=torch.float32, device=dev),
            sh_data=torch.full((n_active, 3 * basis_dim), init_sh, dtype=torch.float32, device=dev),
            radius=radius,
            center=center,
            basis_dim=basis_dim,
        )

    @staticmethod
    def from_numpy(links, density_data, sh_data, radius, center, basis_dim: Optional[int] = None,
                   device: Optional[Union[str, torch.device]] = None) -> "SparseGrid":
        """A grid from host arrays (links int32 [X, Y, Z], density
        [cap, 1], sh [cap, 3B]); basis_dim defaults to sh's width / 3."""
        dev = resolve_device(device)
        sh = np.asarray(sh_data, np.float32)
        return SparseGrid(
            links=torch.from_numpy(np.array(links, dtype=np.int32)).to(dev),
            density_data=torch.from_numpy(np.asarray(density_data, np.float32).reshape(-1, 1).copy()).to(dev),
            sh_data=torch.from_numpy(sh.copy()).to(dev),
            radius=np.broadcast_to(np.asarray(radius, np.float32), (3,)).copy(),
            center=np.asarray(center, np.float32).copy(),
            basis_dim=int(basis_dim) if basis_dim is not None else sh.shape[1] // 3,
        )

    # -- geometry ----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.density_data.device

    @property
    def reso(self) -> Tuple[int, int, int]:
        return tuple(self.links.shape)

    @property
    def capacity(self) -> int:
        return self.density_data.shape[0]

    def world_to_grid(self, pts: torch.Tensor) -> torch.Tensor:
        """World [..., 3] -> voxel-unit grid coordinates (svox2
        convention: g in [-0.5, reso - 0.5] over the box)."""
        return world_to_grid(pts, self.reso, self.radius, self.center)

    def grid_to_world(self, g: torch.Tensor) -> torch.Tensor:
        scale, offset, radius, center = _grid_transform(self.reso, self.radius, self.center, g.device)
        return (g - offset) / scale * radius + center

    # -- persistence -------------------------------------------------------

    def save(self, path: str, background=None):
        """npz with the svox2 key schema (svox2.py:1526-1576).
        ``background``: an ``ops.background.ReferenceBackground`` saved
        under svox2's ``background_data`` / ``background_links`` keys
        (svox2.py:1546-1548), read back by
        ``ops.background.load_reference_background``."""
        data = dict(
            radius=self.radius,
            center=self.center,
            links=self.links.cpu().numpy(),
            density_data=self.density_data.detach().cpu().numpy().astype(np.float32),
            sh_data=self.sh_data.detach().cpu().numpy().astype(np.float16),
            basis_type=0,  # BASIS_TYPE_SH
            basis_dim=self.basis_dim,
        )
        if background is not None:
            from nerf_projects_tpu_torch.ops.background import save_reference_background

            save_reference_background(data, background)
        np.savez_compressed(path, **data)

    @staticmethod
    def load(path: str, device: Optional[Union[str, torch.device]] = None) -> "SparseGrid":
        """Read an svox2-schema npz (as the JAX package's ``save`` and
        svox2 write it) onto ``device``."""
        z = np.load(path)
        sh = z["sh_data"].astype(np.float32)
        basis_dim = int(z["basis_dim"]) if "basis_dim" in z else sh.shape[1] // 3
        return SparseGrid.from_numpy(
            z["links"], z["density_data"], sh, z["radius"], z["center"], basis_dim, device=device,
        )
