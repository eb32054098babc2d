"""Mesh-sharded rendering and the multi-process gates (port of
``nerf_projects_tpu/parallel/render.py``).

Parity target: the reference's distributed inference
(plenoctree/nerf_sh/nerf/utils.py:331-381 ``render_image`` and :701-731
``get_render_pfn``): pad an image's rays to a device multiple, render a
shard on each device, ``all_gather`` the outputs; and the multi-host gates
(host 0 alone logs, per-host data shards, train.py:134-214).

A "process" here is a rank of ``torch.distributed``, which drives one
card; in the JAX package a process is a host, which drives all its
devices. So ``process_index`` is the rank, ``process_count`` the world
size, and ``host_shard_slice`` gives each rank its share of a dataset.
Without a process group there is one process.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from nerf_projects_tpu_torch.core.chunk import chunk_apply, pad_to_multiple, tree_map
from nerf_projects_tpu_torch.core.device import resolve_device
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.parallel.mesh import RAY_AXIS, all_gather_rows, axis_info

# -- multi-process gates (train.py:200,228; datasets.py:81) -----------------


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def host_shard_slice(n: int) -> slice:
    """This process's contiguous shard of an n-element dataset
    (batch_size // host_count splitting, datasets.py:81); the last process
    also takes the remainder."""
    pc, pi = process_count(), process_index()
    per = n // pc
    return slice(pi * per, (pi + 1) * per if pi < pc - 1 else n)


def host_offset_generator(seed: int, device: Optional[Union[str, torch.device]] = None) -> torch.Generator:
    """A generator on ``device`` (None: the card) seeded from (seed,
    this process's index): a different stream on every process, the
    counterpart of ``host_offset_key``'s fold_in (train.py:138,207)."""
    dev = resolve_device(device)
    mixed = int(np.random.SeedSequence([int(seed), process_index()]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=dev).manual_seed(mixed & ((1 << 63) - 1))


# -- sharded rendering -------------------------------------------------------


def render_rays_sharded(mesh, render_fn: Callable[[Rays], dict], rays: Rays, *, chunk: Optional[int] = None):
    """Render a flat [n] ray batch with its rays sharded over the mesh's
    ``RAY_AXIS`` and return numpy arrays of the whole batch, as JAX does.

    Every rank passes the same ``rays``. They are padded to a multiple of
    W (times ``chunk``) by repeating the last ray; each rank renders its
    contiguous shard (in calls of ``chunk`` rays when given), the outputs
    are all-gathered into the full batch on every rank, cropped to n and
    copied to the host. ``render_fn`` maps a ``Rays`` to a dict of
    tensors with the rays' leading axis."""
    return tree_map(lambda t: t.cpu().numpy(), _render_sharded(mesh, render_fn, rays, chunk))


def _render_sharded(mesh, render_fn, rays: Rays, chunk: Optional[int]):
    """``render_rays_sharded``'s outputs as tensors on this rank's device."""
    n = rays.origins.shape[0]
    r, w, group = axis_info(mesh, RAY_AXIS)
    padded = tree_map(lambda t: pad_to_multiple(t, w * (chunk or 1))[0], rays)
    per = padded.origins.shape[0] // w
    local = tree_map(lambda t: t[r * per:(r + 1) * per], padded)
    out = chunk_apply(render_fn, local, chunk) if chunk else render_fn(local)
    return tree_map(lambda t: all_gather_rows(t, group)[:n], out)


def render_image_sharded(mesh, render_fn: Callable[[Rays], dict], rays_image: Rays, *,
                         chunk: Optional[int] = None):
    """``render_rays_sharded`` of an [H, W] image's rays; numpy outputs
    shaped [H, W, ...]."""
    h, w = rays_image.batch_shape
    out = _render_sharded(mesh, render_fn, rays_image.map(lambda t: t.reshape(-1, 3)), chunk)
    return tree_map(lambda t: t.reshape((h, w) + t.shape[1:]).cpu().numpy(), out)
