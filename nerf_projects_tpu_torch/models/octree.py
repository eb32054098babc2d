"""PlenOctree, the svox ``N3Tree`` equivalent (port of
``nerf_projects_tpu/models/octree.py``).

Layout (svox's, kept for npz interop with the JAX package and svox):
  * ``child`` int32 [N, 2, 2, 2]: the offset from a node to the child NODE
    of each of its cells (0 = leaf cell), absolute child = node + child;
  * ``data`` float32 [N, 2, 2, 2, D]: the leaf payload [SH coefficients
    (3 (deg+1)^2) ..., sigma];
  * ``invradius``, ``offset``: world -> unit cube, p_tree = p_world *
    invradius + offset.

The topology is edited on the host in numpy (``child_host``), so that
``leaf_cells()`` and ``child`` match the JAX package's bit for bit and
``n_leaves`` and ``refine`` read no copy back from the card; ``data``
and a device copy of ``child`` live on the tree's device. A query is a
descent of ``depth_limit`` steps, one gather a step, with no per-point
control flow; it is differentiable in ``data`` (``index_select`` rows of
the flat [N * 8, D] payload).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from nerf_projects_tpu_torch.core.device import device_constant, resolve_device

_UNIT_MAX = 1.0 - 1e-7  # the descent's clip below 1 (float32 0.99999988)


def leaf_flat(child: np.ndarray) -> np.ndarray:
    """The flat cell indices node * 8 + i * 4 + j * 2 + k of every leaf
    cell of the host topology, in C order (``leaf_cells()``'s order)."""
    return np.flatnonzero(child.reshape(-1) == 0)


def cells_of(flat: np.ndarray) -> np.ndarray:
    """Flat cell indices [L] -> (node, i, j, k) [L, 4]."""
    return np.stack([flat >> 3, (flat >> 2) & 1, (flat >> 1) & 1, flat & 1], -1)


def refine_topology(child: np.ndarray, leaf_mask: Optional[np.ndarray] = None, leaves: Optional[np.ndarray] = None):
    """Split leaf cells of the host topology ``child`` int32 [N, 2, 2, 2]
    into new nodes appended in ``leaf_cells()`` order (svox N3Tree.refine):
    (new child [N + n, 2, 2, 2], the split cells' flat indices [n]).
    ``leaf_mask``: bool over ``leaf_cells()`` order, None = every leaf;
    ``leaves``: ``leaf_flat(child)``, when the caller has it."""
    flat = leaf_flat(child) if leaves is None else leaves
    if leaf_mask is not None:
        flat = flat[np.asarray(leaf_mask)]
    if len(flat) == 0:
        return child, flat
    n_old, n_new = child.shape[0], len(flat)
    out = np.zeros((n_old + n_new, 2, 2, 2), np.int32)
    out[:n_old] = child
    out.reshape(-1)[flat] = (n_old + np.arange(n_new) - (flat >> 3)).astype(np.int32)
    return out, flat


class PlenOctree:
    """An octree of leaf payloads on one device, its topology mirrored on
    the host."""

    def __init__(self, child, data: torch.Tensor, invradius, offset, depth_limit: int = 10, *,
                 child_device: Optional[torch.Tensor] = None):
        """``child``: the topology, host numpy (or a tensor, copied to the
        host); ``child_device``: its copy on ``data``'s device, if made."""
        host = child.detach().cpu().numpy() if torch.is_tensor(child) else np.asarray(child)
        self.child_host = np.ascontiguousarray(host, np.int32)
        self.data = data
        if child_device is None or child_device.device != data.device:
            child_device = torch.from_numpy(self.child_host).to(data.device)
        self.child = child_device
        self.invradius = np.asarray(invradius, np.float32).copy()
        self.offset = np.asarray(offset, np.float32).copy()
        self.depth_limit = int(depth_limit)

    def replace(self, *, data: Optional[torch.Tensor] = None, child: Optional[np.ndarray] = None) -> "PlenOctree":
        """A tree with new ``data`` and / or host topology ``child``,
        sharing the rest."""
        return PlenOctree(self.child_host if child is None else child, self.data if data is None else data,
                          self.invradius, self.offset, self.depth_limit,
                          child_device=self.child if child is None else None)

    def to(self, device) -> "PlenOctree":
        return self.replace(data=self.data.to(device))

    # -- construction ------------------------------------------------------

    @staticmethod
    def create(data_dim: int, *, center=(0.0, 0.0, 0.0), radius=1.0, depth_limit: int = 10,
               device: Optional[Union[str, torch.device]] = None) -> "PlenOctree":
        """A single root covering the cube center +- radius, on ``device``
        (None: the card)."""
        dev = resolve_device(device)
        radius = np.broadcast_to(np.asarray(radius, np.float32), (3,)).copy()
        center = np.asarray(center, np.float32)
        invradius = 0.5 / radius
        offset = 0.5 - center * invradius
        return PlenOctree(np.zeros((1, 2, 2, 2), np.int32),
                          torch.zeros((1, 2, 2, 2, data_dim), dtype=torch.float32, device=dev),
                          invradius, offset, depth_limit)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def n_nodes(self) -> int:
        return self.child_host.shape[0]

    @property
    def data_dim(self) -> int:
        return self.data.shape[-1]

    @property
    def n_leaves(self) -> int:
        return int((self.child_host == 0).sum())

    def world_to_tree(self, pts: torch.Tensor) -> torch.Tensor:
        return pts * device_constant(self.invradius, torch.float32, pts.device) + \
            device_constant(self.offset, torch.float32, pts.device)

    def tree_to_world(self, pts: torch.Tensor) -> torch.Tensor:
        return (pts - device_constant(self.offset, torch.float32, pts.device)) / \
            device_constant(self.invradius, torch.float32, pts.device)

    # -- host-side topology ------------------------------------------------

    def leaf_cells(self) -> np.ndarray:
        """[L, 4] (node, i, j, k) of every leaf cell, in C order."""
        return cells_of(leaf_flat(self.child_host))

    def leaf_geometry(self):
        """(flat cell index [L], depth [L], unit-cube lower corner [L, 3],
        edge [L]) of every leaf, in ``leaf_cells()`` order, by the native
        walk (``utils/native.py``)."""
        from nerf_projects_tpu_torch.utils import native

        depth_c, corner_c, size_c, _ = native.octree_leaf_geometry(self.child_host)
        flat = leaf_flat(self.child_host)
        return flat, depth_c.reshape(-1)[flat], corner_c.reshape(-1, 3)[flat], size_c.reshape(-1)[flat]

    def leaf_depths_and_corners(self):
        """(cells [L, 4], depth [L], unit-cube lower corner [L, 3], edge
        [L]) of every leaf (the JAX package's form of ``leaf_geometry``)."""
        flat, depth, corner, size = self.leaf_geometry()
        return cells_of(flat), depth, corner, size

    def max_depth(self) -> int:
        """The depth of the deepest leaf cell (the root's cells are at
        depth 1), level by level through ``child_host``."""
        child = self.child_host.reshape(-1, 8)
        frontier, depth = np.zeros(1, np.int64), 0
        while frontier.size:
            depth += 1
            rel = child[frontier]
            frontier = (frontier[:, None] + rel)[rel != 0]
        return depth

    def refine(self, leaf_mask: Optional[np.ndarray] = None) -> "PlenOctree":
        """Split leaf cells into child nodes whose eight cells inherit the
        parent cell's data (svox N3Tree.refine); ``leaf_mask`` bool [L]
        over ``leaf_cells()`` order, None = all. Returns a new tree."""
        child, flat = refine_topology(self.child_host, leaf_mask)
        if len(flat) == 0:
            return self
        inherited = self.data.reshape(-1, self.data_dim).index_select(0, torch.from_numpy(flat).to(self.device))
        new = inherited[:, None, None, None, :].expand(len(flat), 2, 2, 2, self.data_dim)
        return self.replace(data=torch.cat([self.data, new], 0), child=child)

    def leaf_order_lookup(self) -> np.ndarray:
        """Host [N, 2, 2, 2] map from (node, cell) to that cell's row in
        ``leaf_cells()`` order (-1 for internal cells)."""
        lut = np.full(self.child_host.shape, -1, np.int64)
        flat = leaf_flat(self.child_host)
        lut.reshape(-1)[flat] = np.arange(len(flat))
        return lut

    # -- device-side query -------------------------------------------------

    def locate_flat(self, pts_world: torch.Tensor):
        """(flat cell index node * 8 + i * 4 + j * 2 + k [...] int64,
        inside [...] bool) of the leaf holding each world point [..., 3]."""
        t = self.world_to_tree(pts_world)
        inside = torch.all((t >= 0.0) & (t < 1.0), dim=-1)
        pos = torch.clamp(t, 0.0, _UNIT_MAX)
        child = self.child.reshape(-1)
        node = torch.zeros(pos.shape[:-1], dtype=torch.int64, device=pos.device)
        # a leaf's cell keeps its position, so the next step finds the same
        # leaf (rel 0): no "done" flag is needed
        for _ in range(self.depth_limit):
            cell = torch.clamp((pos * 2).to(torch.int32), max=1)
            flat = node * 8 + (cell[..., 0] * 4 + cell[..., 1] * 2 + cell[..., 2])
            rel = child[flat]
            node = node + rel
            pos = torch.where((rel == 0)[..., None], pos, pos * 2 - cell.to(pos.dtype))
        cell = torch.clamp((pos * 2).to(torch.int32), max=1)
        return node * 8 + (cell[..., 0] * 4 + cell[..., 1] * 2 + cell[..., 2]), inside

    def locate(self, pts_world: torch.Tensor):
        """(node [...], cell [..., 3] int, inside [...] bool) of the leaf
        holding each world point [..., 3]."""
        flat, inside = self.locate_flat(pts_world)
        node = flat // 8
        c = flat % 8
        return node, torch.stack([c // 4, (c // 2) % 2, c % 2], dim=-1), inside

    def query(self, pts_world: torch.Tensor, column: Optional[int] = None) -> torch.Tensor:
        """Leaf data at world points [..., 3] -> [..., D] (or one
        ``column`` -> [...]); zeros outside the cube."""
        flat, inside = self.locate_flat(pts_world)
        rows = self.data.reshape(-1, self.data_dim)
        if column is not None:
            rows = rows[:, column]
            vals = rows.index_select(0, flat.reshape(-1)).reshape(flat.shape)
            return torch.where(inside, vals, 0.0)
        vals = rows.index_select(0, flat.reshape(-1)).reshape(flat.shape + (self.data_dim,))
        return torch.where(inside[..., None], vals, 0.0)

    # -- persistence -------------------------------------------------------

    def _parent_depth_table(self) -> np.ndarray:
        """svox bookkeeping [N, 2] int32: the packed parent pointer
        (parent * 8 + flat cell) and the node depth; the root's row stays
        (0, 0)."""
        from nerf_projects_tpu_torch.utils import native

        child = self.child_host.reshape(-1)
        pd = np.zeros((self.n_nodes, 2), np.int32)
        flat = np.flatnonzero(child)  # parent * 8 + cell of every internal cell
        tgt = (flat >> 3) + child[flat]
        pd[tgt, 0] = flat.astype(np.int32)
        # a cell's depth is its node's + 1, which is the depth of the node it holds
        pd[tgt, 1] = native.octree_leaf_geometry(self.child_host)[0].reshape(-1)[flat]
        return pd

    def save(self, path: str, *, compress: bool = True):
        """svox-style npz, the JAX package's keys: child / data (float16) /
        invradius3 / offset / depth_limit / data_dim and the bookkeeping
        svox's N3Tree.load requires (parent_depth, n_internal, n_free,
        geom_resize_fact)."""
        saver = np.savez_compressed if compress else np.savez
        saver(
            path,
            child=self.child_host,
            data=self.data.detach().cpu().numpy().astype(np.float16),
            invradius3=self.invradius,
            offset=self.offset,
            depth_limit=self.depth_limit,
            data_dim=self.data_dim,
            parent_depth=self._parent_depth_table(),
            n_internal=np.int64(self.n_nodes),
            n_free=np.int64(0),
            geom_resize_fact=np.float64(1.0),
        )

    @staticmethod
    def load(path: str, device: Optional[Union[str, torch.device]] = None) -> "PlenOctree":
        """Read a tree saved by either package (or svox, ``invradius``
        scalar) onto ``device`` (None: the card)."""
        dev = resolve_device(device)
        z = np.load(path)
        inv = z["invradius3"] if "invradius3" in z else np.repeat(np.float32(z["invradius"]), 3)
        return PlenOctree(
            z["child"].astype(np.int32),
            torch.from_numpy(z["data"].astype(np.float32)).to(dev),
            inv.astype(np.float32),
            z["offset"].astype(np.float32),
            int(z["depth_limit"]) if "depth_limit" in z else 10,
        )


def refine_at_points(tree: PlenOctree, pts_world: torch.Tensor, rounds: int) -> PlenOctree:
    """``rounds`` times, split every leaf that holds one of the world
    points [M, 3] (on the tree's device): the refine loop of extraction
    and of ``to_octree``. For a fresh tree (zero data): the topology is
    edited on the host and the zero data made once at the end, which is
    what refining a zero tree gives."""
    child = tree.child_host
    dev = tree.device
    for _ in range(rounds):
        probe = PlenOctree(child, tree.data[:0], tree.invradius, tree.offset, tree.depth_limit)
        flat, _ = probe.locate_flat(pts_world)
        touched = torch.zeros(child.size, dtype=torch.bool, device=dev)
        touched[flat] = True
        leaves = leaf_flat(child)
        child, _ = refine_topology(child, touched.cpu().numpy()[leaves], leaves)
    data = torch.zeros(child.shape + (tree.data_dim,), dtype=torch.float32, device=dev)
    return PlenOctree(child, data, tree.invradius, tree.offset, tree.depth_limit)
