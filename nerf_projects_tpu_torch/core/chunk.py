"""Chunked evaluation helpers, the reference's ``batchify`` (port of
``nerf_projects_tpu/core/chunk.py``).

The reference chunks ray batches (``chunk``, notebook cell 11) and MLP
point batches (``netchunk``, cell 8) to bound peak memory. As in the JAX
package every chunk has the same shape: the tail is padded by repeating
its last entry, not shrunk, so a kernel sees one shape and a padded lane
is a real ray (no zero-length direction). The loop is a Python loop; the
padded results are cropped.
"""
from __future__ import annotations

from typing import Callable

import torch


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` to a multiple of ``multiple`` by repeating
    its last entry. Returns (padded, original_size); ``x`` itself when no
    padding is needed (reference nerf_sh/nerf/utils.py:353-369)."""
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x, size
    last = x.narrow(axis, size - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = pad
    return torch.cat([x, last.repeat(reps)], dim=axis), size


def tree_map(fn, tree):
    """``fn`` on every tensor of a tensor, or of a dict, tuple, list or
    NamedTuple (a ``Rays``, a ``RenderOutputs``) of them (nested), keeping
    the structure. A ``None`` leaf stays ``None``, as in a JAX pytree."""
    if torch.is_tensor(tree):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The tensors of a tree, in ``tree_map``'s order (``None`` leaves
    skipped, as ``jax.tree_util.tree_leaves`` does)."""
    out = []
    tree_map(out.append, tree)
    return out


def chunk_apply(fn: Callable, x, chunk_size: int):
    """``fn`` over leading-axis chunks of ``x`` (a tensor, a ``Rays``, or
    a dict or tuple of them, all with one leading size), the results
    concatenated and cropped. The input is padded to whole chunks
    (``pad_to_multiple``), so ``fn`` sees ``chunk_size`` rows every call."""
    n = tree_leaves(x)[0].shape[0]
    padded = tree_map(lambda t: pad_to_multiple(t, chunk_size)[0], x)
    outs = [fn(tree_map(lambda t: t[i: i + chunk_size], padded)) for i in range(0, n, chunk_size)]
    joined = iter([torch.cat(parts, dim=0)[:n] for parts in zip(*(tree_leaves(o) for o in outs))])
    return tree_map(lambda _: next(joined), outs[0])
