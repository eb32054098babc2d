"""Process groups, the device mesh and the ray layout (port of
``nerf_projects_tpu/parallel/mesh.py``).

The reference's distributed story is ray-batch data parallelism:
``jax.pmap(train_step, axis_name="batch")`` with replicated parameters
and ``lax.pmean`` of the gradients (plenoctree/nerf_sh/train.py:184-198),
and all-gathered rendering (nerf_sh/nerf/utils.py:701-731). The JAX
package writes it as one jit over a "rays" mesh axis, with ``shard_map``
around its Pallas kernels.

Here a device is a process (a rank of ``torch.distributed``) that owns one
card, or the host. The mesh is a ``DeviceMesh`` over the ranks with named
dimensions; a batch's leading axis is split into contiguous shards along
``RAY_AXIS`` (rank r of W holds rows [r n / W, (r + 1) n / W), the rows
JAX's ``NamedSharding(mesh, P("rays"))`` gives device r), and parameters
are replicated. The collectives are explicit, as in JAX's ``shard_map``:
the kernels are ``ctypes`` calls, through which a sharding annotation
would not pass. Only ``all_reduce``, ``broadcast`` and ``all_gather`` are
used, so one code path runs under NCCL and under gloo, on host tensors or
on the card's.

``init_distributed`` sets up the group, from ``torchrun``'s environment or
from explicit arguments; ``make_mesh`` without a group sets up the group
of one process.
"""
from __future__ import annotations

import os
import tempfile
from datetime import timedelta
from typing import Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from nerf_projects_tpu_torch.core.chunk import tree_leaves, tree_map

RAY_AXIS = "rays"
COLLECTIVE_TIMEOUT_S = 60.0  # a rank that waits longer in a collective raises


def init_distributed(
    backend: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    *,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
) -> torch.device:
    """Join (or, alone, make) the default process group and return this
    rank's device.

    rank and world_size default to ``torchrun``'s RANK and WORLD_SIZE (0
    and 1 without them); init_method to ``env://`` under ``torchrun`` and
    a fresh ``file://`` rendezvous for a lone process. ``device``: None
    means card LOCAL_RANK (else the rank) of this machine; ``"cpu"`` the
    host; an indexed CUDA device is taken as given (two ranks can share
    one card that way, over gloo). The device is made current
    (``torch.cuda.set_device``) before the group exists, so nothing runs
    on another card. ``backend`` defaults to ``nccl`` for a card and
    ``gloo`` for the host. A collective that waits longer than
    COLLECTIVE_TIMEOUT_S raises instead of hanging."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = torch.device("cuda", local_rank) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if init_method is None:
        if "MASTER_ADDR" in env:
            init_method = "env://"
        elif world_size == 1:
            init_method = "file://" + os.path.join(tempfile.mkdtemp(prefix="nerf_pg_"), "rendezvous")
        else:
            raise ValueError("init_method is needed for more than one process outside torchrun")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return dev


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Optional[Mapping[str, int]] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
):
    """A ``DeviceMesh`` over the ranks (one device each) with named
    dimensions: ``axes`` an ordered {name: size} mapping, by default 1-D
    {"rays": n_devices}; {"rays": 4, "grid": 2} gives a 2-D mesh. Without
    a process group it first makes the group of this one process (on
    ``device``: None the card, as entry points default), so it is then the
    mesh of world size 1. n_devices defaults to, and must equal, the world
    size; ValueError when the axes do not multiply to it. The mesh's device
    type is ``device``'s, else "cuda" under NCCL and "cpu" otherwise (the
    collectives take the tensors' devices whatever it says)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        init_distributed(device=device, rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if axes is None:
        axes = {RAY_AXIS: n_devices}
    sizes = [int(s) for s in axes.values()]
    if int(np.prod(sizes)) != n_devices:
        raise ValueError(f"mesh axes {dict(axes)} do not multiply to {n_devices}")
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs as many ranks; the group has {world}")
    kind = torch.device(device).type if device is not None else ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(kind, torch.arange(n_devices).reshape(sizes), mesh_dim_names=tuple(axes))


def axis_info(mesh, axis: str = RAY_AXIS):
    """(this rank's place on ``axis``, the axis' size, its process group)."""
    d = mesh.mesh_dim_names.index(axis)
    return mesh.get_local_rank(d), mesh.size(d), mesh.get_group(d)


def shard_slice(mesh, n: int, axis: str = RAY_AXIS) -> slice:
    """This rank's contiguous rows of an n-row batch sharded on ``axis``:
    [r n / W, (r + 1) n / W). ValueError unless W divides n."""
    r, w, _ = axis_info(mesh, axis)
    if n % w:
        raise ValueError(f"{n} rows do not split evenly over {w} devices on axis {axis!r}")
    per = n // w
    return slice(r * per, (r + 1) * per)


def shard_rays(mesh, tree, axis: str = RAY_AXIS):
    """This rank's shard (``shard_slice``) of the leading axis of every
    tensor of ``tree`` (a tensor, ``Rays``, dict or tuple), as views."""
    sl = shard_slice(mesh, tree_leaves(tree)[0].shape[0], axis)
    return tree_map(lambda t: t[sl], tree)


def replicate(mesh, tree):
    """Every tensor of ``tree`` broadcast from the mesh's first rank to
    all its ranks (new tensors; the caller's are not written)."""
    src = int(mesh.mesh.flatten()[0])

    def bcast(t):
        t = t.detach().clone().contiguous()
        dist.broadcast(t, src=src)
        return t

    return tree_map(bcast, tree)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``t`` (one shape on every rank) concatenated along the
    leading axis, in rank order, on every rank."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)
