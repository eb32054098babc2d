"""The dense sweep of the Plenoxels touched step (``train/plenoxels_sparse.py``,
``dense_optim``): the whole packed state from K4's gradient arrays to the
new state in one pass.

``dense_sweep`` checks its inputs, then launches the CUDA kernel
``csrc/dense_sweep.cu`` (sm_90a, built with nvcc and loaded with ctypes)
for CUDA tensors and runs ``dense_sweep_reference``, its plain PyTorch
version, for host tensors; a CUDA call launches or raises. The kernel
replaces no TPU kernel: the JAX package leaves this sweep to XLA's
fusion. ``packed_update`` is the optimizer's arithmetic on packed rows,
which the plain sweep and the row steps share; ``dense_grad`` lays K4's
gradient arrays into the packed layout, for the plain sweep and the dense
packed step.

What it computes, per element of the packed state [nb + 1, 512, CP]: the
gradient g = grad * mask (K4's ``grad_density`` [nb, 512] on channel 0,
``grad_sh`` [nb, 512, 3B] on channels 1 .. 3B, 0 on the padding channels
and on the sentinel row nb), per-visit RMSprop or SGD with lr_sigma on
channel 0 and lr_sh on the others, the density floor on channel 0, and
the old master and rms kept where g == 0; the bf16 cells are the new
masters rounded, and ``last_step`` is ``step`` on the flagged rows, -1
on the sentinel. The kernel computes the plain version's bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from nerf_projects_tpu_torch.ops.kernels.fused_mlp import _INT, _VP, check_tensor, launch_stream, load_library
from nerf_projects_tpu_torch.ops.kernels.tile_march import BASIS_DIMS, channels

CELLS = 512


def _lr_channels(x: torch.Tensor, lr_sigma: float, lr_sh: float) -> torch.Tensor:
    """``x`` [..., CP] scaled by lr_sigma on the density channel and lr_sh
    on the others (a new tensor; host numbers only)."""
    out = x * lr_sh
    out[..., 0] = x[..., 0] * lr_sigma
    return out


def packed_update(data, g, rms_old, decay, *, lr_sigma: float, lr_sh: float, beta: float, density_minval: float,
                  rmsprop: bool):
    """RMSprop (``rmsprop``) or SGD on packed rows with per-channel
    learning rates and the density floor (on where ``density_minval`` >
    -1e8): (new, rms). ``decay``: the rms decay (b, or b^D per row), or
    None for per-visit RMSprop, where rms moves only where g != 0."""
    if rmsprop:
        if decay is None:
            rms = torch.where(g == 0.0, rms_old,
                              torch.where(rms_old == 0.0, g * g, beta * rms_old + (1.0 - beta) * g * g))
        else:
            rms = torch.where(rms_old == 0.0, g * g, decay * rms_old + (1.0 - beta) * g * g)
        upd = _lr_channels(g / (torch.sqrt(rms) + 1e-8), lr_sigma, lr_sh)
    else:
        rms = rms_old
        upd = _lr_channels(g, lr_sigma, lr_sh)
    new = data - upd
    if density_minval > -1e8:
        new[..., 0] = torch.clamp(new[..., 0], min=density_minval)
    return new, rms


def dense_grad(shape, grad_density: torch.Tensor, grad_sh: torch.Tensor, cell_mask: torch.Tensor) -> torch.Tensor:
    """K4's ``grad_density`` [nb, 512] and ``grad_sh`` [nb, 512, 3B] laid
    into a new packed float32 tensor of ``shape`` [nb + 1, 512, CP] and
    masked by the bool ``cell_mask`` [nb, 512]: 0 on the padding channels,
    the masked cells and the sentinel row nb."""
    nb = grad_density.shape[0]
    acc = torch.zeros(shape, dtype=torch.float32, device=grad_density.device)
    acc[:nb, :, 0] = grad_density
    acc[:nb, :, 1:1 + grad_sh.shape[-1]] = grad_sh
    mask = torch.cat([cell_mask.float(), torch.zeros_like(cell_mask[:1], dtype=torch.float32)])[..., None]
    return acc * mask


def dense_sweep_reference(packed, rms, grad_density, grad_sh, cell_mask, flag, last_step, *, step: int,
                          lr_sigma: float, lr_sh: float, beta: float, density_minval: float, rmsprop: bool,
                          cells: bool = True):
    """The plain version of ``dense_sweep``: the gradients laid into the
    packed layout and masked (``dense_grad``), ``packed_update`` with per-visit
    RMSprop over the whole state and ``where(g == 0)`` keeping the
    elements without a gradient. Returns (packed, rms, cells or None,
    last_step), new tensors but rms under SGD (returned as it is)."""
    nb = grad_density.shape[0]
    g = dense_grad(packed.shape, grad_density, grad_sh, cell_mask)
    new, rms_new = packed_update(packed, g, rms.float(), None, lr_sigma=lr_sigma, lr_sh=lr_sh, beta=beta,
                                 density_minval=density_minval, rmsprop=rmsprop)
    new = torch.where(g == 0.0, packed, new)
    last = torch.where(flag == 1, int(step), last_step)
    last[nb].fill_(-1)
    return new, rms_new.to(rms.dtype) if rmsprop else rms, new.to(torch.bfloat16) if cells else None, last


def _check_inputs(packed, rms, grad_density, grad_sh, cell_mask, flag, last_step) -> int:
    """The wrapper's checks, before anything is built: dtypes, shapes,
    contiguity and one device. Returns basis_dim."""
    dev = packed.device
    if packed.dim() != 3:
        raise ValueError(f"packed must be [nb + 1, 512, CP], got shape {tuple(packed.shape)}")
    rows, cp = packed.shape[0], packed.shape[2]
    nb = rows - 1
    if grad_sh.dim() != 3 or grad_sh.shape[-1] % 3:
        raise ValueError(f"grad_sh must be [nb, 512, 3B], got shape {tuple(grad_sh.shape)}")
    B = grad_sh.shape[-1] // 3
    if B not in BASIS_DIMS or channels(B) != cp:
        raise ValueError(f"grad_sh's 3B = {3 * B} channels do not fit packed's {cp} (basis_dim in {BASIS_DIMS})")
    check_tensor(packed, "packed", torch.float32, (rows, CELLS, cp), dev)
    if rms.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rms must be torch.float32 or torch.bfloat16, got {rms.dtype}")
    check_tensor(rms, "rms", rms.dtype, (rows, CELLS, cp), dev)
    for t, name, dtype, shape in ((grad_density, "grad_density", torch.float32, (nb, CELLS)),
                                  (grad_sh, "grad_sh", torch.float32, (nb, CELLS, 3 * B)),
                                  (cell_mask, "cell_mask", torch.bool, (nb, CELLS)),
                                  (flag, "flag", torch.int32, (rows,)),
                                  (last_step, "last_step", torch.int32, (rows,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B


@functools.lru_cache(maxsize=None)
def _library():
    F = ctypes.c_float
    return load_library("dense_sweep", {
        "dense_sweep": ([_VP] * 11 + [_INT] * 5 + [F, F, F, F, _INT, F, _VP], _INT),
        "dense_sweep_error_string": ([_INT], ctypes.c_char_p),
    })


def dense_sweep(packed: torch.Tensor, rms: torch.Tensor, grad_density: torch.Tensor, grad_sh: torch.Tensor,
                cell_mask: torch.Tensor, flag: torch.Tensor, last_step: torch.Tensor, *, step: int,
                lr_sigma: float, lr_sh: float, beta: float, density_minval: float, rmsprop: bool,
                cells: bool = True):
    """The sweep of ``packed`` float32 [nb + 1, 512, CP] and its ``rms``
    (float32 or bf16, its shape) from K4's ``grad_density`` float32 [nb,
    512] and ``grad_sh`` float32 [nb, 512, 3B], the bool ``cell_mask`` [nb,
    512], int32 ``flag`` and ``last_step`` [nb + 1], with the learning
    rates and beta as host numbers -> (packed, rms, bf16 cells or None
    (``cells`` False), last_step), new tensors but rms under SGD (not
    read, returned as it is). Checks every input, then runs the plain
    version for host tensors and launches the kernel on the current stream
    for CUDA tensors."""
    B = _check_inputs(packed, rms, grad_density, grad_sh, cell_mask, flag, last_step)
    numbers = dict(step=step, lr_sigma=lr_sigma, lr_sh=lr_sh, beta=beta, density_minval=density_minval,
                   rmsprop=rmsprop, cells=cells)
    dev = packed.device
    if dev.type == "cpu":
        return dense_sweep_reference(packed, rms, grad_density, grad_sh, cell_mask, flag, last_step, **numbers)
    if dev.type != "cuda":
        raise ValueError(f"dense_sweep runs on a CUDA device or the CPU, got {dev}")
    lib = _library()
    new = torch.empty_like(packed)
    rms_new = torch.empty_like(rms) if rmsprop else rms
    cells_new = torch.empty(packed.shape, dtype=torch.bfloat16, device=dev) if cells else None
    last = torch.empty_like(last_step)

    def ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    with launch_stream(dev) as stream:
        rc = lib.dense_sweep(
            packed.data_ptr(), ptr(rms if rmsprop else None), grad_density.data_ptr(), grad_sh.data_ptr(),
            cell_mask.data_ptr(), flag.data_ptr(), last_step.data_ptr(), new.data_ptr(),
            ptr(rms_new if rmsprop else None), ptr(cells_new), last.data_ptr(), grad_density.shape[0], B,
            int(rms.dtype == torch.bfloat16), int(rmsprop), int(step), float(lr_sigma), float(lr_sh), float(beta),
            1.0 - float(beta), int(density_minval > -1e8), float(density_minval), stream)
    if rc != 0:
        raise RuntimeError(f"dense_sweep launch failed: {lib.dense_sweep_error_string(rc).decode()}")
    dense_sweep.launches += 1
    return new, rms_new, cells_new, last


dense_sweep.launches = 0
