"""Training checkpoints of the NeRF and NeRF-SH trainers, one
``torch.save`` file each: the step, the state's models' state dicts,
Adam's state and the state's generator. The JAX trainers' TrainState
carries its PRNG key, so the port's checkpoint carries its generator.
A state names its modules in ``models`` (``None`` for an absent one)."""
from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, state):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({
        "step": int(state.step),
        "models": [None if m is None else m.state_dict() for m in state.models],
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
    }, path)


def load_checkpoint(path: str, template):
    """Restore a ``save_checkpoint`` file into ``template`` (in place):
    read by ``torch.load`` (weights only) onto the device of its
    generator. Adam keeps its step counts on the host, and a generator
    takes its state as a host byte tensor, so those two stay there."""
    ckpt = torch.load(path, map_location=template.generator.device, weights_only=True)
    opt = ckpt["optimizer"]
    for s in opt["state"].values():
        s["step"] = s["step"].cpu()
    template.optimizer.load_state_dict(opt)
    template.generator.set_state(ckpt["generator"].cpu())
    template.step = int(ckpt["step"])
    for model, sd in zip(template.models, ckpt["models"]):
        if model is not None:
            model.load_state_dict(sd)
    return template
