"""Device selection for the port's entry points, and small constants
kept on a device."""
from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises;
    the host runs only when the caller asks for ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    return dev


@functools.lru_cache(maxsize=256)
def _constant(shape, flat, dtype, device) -> torch.Tensor:
    return torch.tensor(flat, dtype=dtype, device=device).reshape(shape)


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` (host numbers) as a tensor on ``device``, copied there
    once per (values, dtype, device) and then reused. A copy of host
    numbers to the card waits for the card's queue to drain, so the hot
    paths take their constants (grid resolution, radius, offsets) from
    here. The tensor is shared: never write to it."""
    arr = np.asarray(values)
    return _constant(arr.shape, tuple(arr.ravel().tolist()), dtype, torch.device(device))
