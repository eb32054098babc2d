"""TensorBoard logging, a thin tensorboardX wrapper (port of
``nerf_projects_tpu/obs/tb.py``).

Parity target: the TensorBoard scalar/image writers present in every
reference trainer (nerf_sh/train.py:200-247, svox2/opt/opt.py:281+,
notebook cell 19). A no-op when tensorboardX is unavailable (the card's
machine has none); values may be host numbers or tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SummaryWriter:
    def __init__(self, log_dir: str):
        self._w = None
        try:
            from tensorboardX import SummaryWriter as TBWriter

            self._w = TBWriter(log_dir)
        except Exception:
            pass

    @property
    def active(self) -> bool:
        return self._w is not None

    def scalar(self, tag: str, value, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, float(_host(value)), int(step))

    def image(self, tag: str, img, step: int):
        """img: [H, W, 3] float in [0, 1]."""
        if self._w is not None:
            self._w.add_image(tag, np.clip(_host(img), 0, 1), int(step), dataformats="HWC")

    def histogram(self, tag: str, values, step: int):
        if self._w is not None:
            self._w.add_histogram(tag, _host(values), int(step))

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()
