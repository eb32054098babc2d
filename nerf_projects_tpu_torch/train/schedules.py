"""Learning-rate schedules (port of ``nerf_projects_tpu/train/schedules.py``).

  * exponential decay ``lrate * 0.1^(step / (lrate_decay*1000))`` — vanilla
    NeRF (reference nerf/nerf.ipynb cell 19 §8).
  * log-linear lerp with a reverse-cosine warmup delay — jaxnerf
    ``learning_rate_decay`` and Plenoxels ``get_expon_lr_func``.

Each is a function of the step, for a Python number (giving a float) or
a tensor (giving a float32 tensor on its device).
"""
from __future__ import annotations

import math

import torch


def exponential_decay(lrate_init: float, lrate_decay: float):
    """Vanilla NeRF schedule: 0.1 decay every lrate_decay*1000 steps."""

    def schedule(step):
        if torch.is_tensor(step):
            step = step.float()
        return lrate_init * (0.1 ** (step / (lrate_decay * 1000.0)))

    return schedule


def log_linear_decay(
    lr_init: float,
    lr_final: float,
    max_steps: int,
    *,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
):
    """lr(step) = delay_rate(step) * exp(lerp(log lr_init, log lr_final, t)),
    t = clip(step/max_steps, 0, 1); the delay ramps from lr_delay_mult to 1
    over lr_delay_steps with a smooth half-cosine."""

    def schedule(step):
        if torch.is_tensor(step):
            s = step.float()
            t = torch.clamp(s / max_steps, 0.0, 1.0)
            log_lerp = torch.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)
            if lr_delay_steps > 0:
                ramp = torch.sin(0.5 * math.pi * torch.clamp(s / lr_delay_steps, 0.0, 1.0))
                return (lr_delay_mult + (1.0 - lr_delay_mult) * ramp) * log_lerp
            return log_lerp
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)
        if lr_delay_steps > 0:
            ramp = math.sin(0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
            return (lr_delay_mult + (1.0 - lr_delay_mult) * ramp) * log_lerp
        return log_lerp

    return schedule
