"""Run one function on W ranks in processes of their own and collect what
each returns: the multi-process launcher of the port's tests and of its
card checks (a job on several cards is started by ``torchrun`` instead).

``run_ranks("pkg.module:function", W, kwargs)`` (or ``start_ranks``, which
returns before they end) spawns W fresh interpreters
(``torch.multiprocessing.start_processes``). Each joins a process group
through a ``file://`` rendezvous in a temporary directory (so concurrent
launches never race for a port), calls ``function(**kwargs)`` and saves
the result. A rank that raises has its traceback raised in the caller,
and its peers are stopped; the caller waits at most JOIN_TIMEOUT_S
seconds in all. A child imports only this module and the target's
module (and the caller's main script, as any spawned process does).
"""
from __future__ import annotations

import importlib
import os
import shutil
import tempfile
import time
from typing import Optional

import torch

JOIN_TIMEOUT_S = 120.0  # the longest the caller waits for its ranks


class RankJob:
    """W ranks started by ``start_ranks``; ``join`` waits for them."""

    def __init__(self, target: str, world_size: int, kwargs: dict, backend: str, device: str):
        self.target, self.world_size = target, world_size
        self.work = tempfile.mkdtemp(prefix="nerf_ranks_")
        spec = os.path.join(self.work, "spec.pt")
        torch.save(dict(target=target, world_size=world_size, kwargs=kwargs, backend=backend, device=device,
                        init_method="file://" + os.path.join(self.work, "rendezvous"), out=self.work), spec)
        self.deadline = time.monotonic() + JOIN_TIMEOUT_S
        self.context = torch.multiprocessing.start_processes(_rank, (spec,), nprocs=world_size, join=False)

    def join(self) -> list:
        """The ranks' results in rank order, their tensors on the host. A
        rank's exception is raised here (``ProcessRaisedException`` with
        its traceback), RuntimeError when the time ran out; every rank
        still running is killed first."""
        try:
            try:
                while not self.context.join(max(self.deadline - time.monotonic(), 0.0)):
                    if time.monotonic() >= self.deadline:
                        raise RuntimeError(f"{self.target} on {self.world_size} ranks timed out after "
                                           f"{JOIN_TIMEOUT_S:.0f} s")
            finally:
                for p in self.context.processes:
                    if p.is_alive():
                        p.kill()
                    p.join()
            return [torch.load(os.path.join(self.work, f"rank{r}.pt"), map_location="cpu", weights_only=False)
                    for r in range(self.world_size)]
        finally:
            shutil.rmtree(self.work, ignore_errors=True)


def start_ranks(target: str, world_size: int, kwargs: Optional[dict] = None, *, backend: str = "gloo",
                device: str = "cpu") -> RankJob:
    """Start ``target`` ("module:function") on ``world_size`` ranks of a
    ``backend`` group, each on ``device`` (an indexed CUDA device is
    shared by all ranks; None gives rank r card r), and return at once."""
    return RankJob(target, world_size, kwargs or {}, backend, device)


def run_ranks(target: str, world_size: int, kwargs: Optional[dict] = None, **kw) -> list:
    """``start_ranks(...).join()``."""
    return start_ranks(target, world_size, kwargs, **kw).join()


def _rank(rank: int, spec_path: str) -> None:
    """One rank: join the group, run the target, save its result."""
    import torch.distributed as dist

    from nerf_projects_tpu_torch.parallel.mesh import init_distributed

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        os.environ.pop(k, None)  # the caller's own group, if any, is not this one
    spec = torch.load(spec_path, weights_only=False)
    init_distributed(spec["backend"], spec["device"], rank=rank, world_size=spec["world_size"],
                     init_method=spec["init_method"])
    mod, fn = spec["target"].split(":")
    result = getattr(importlib.import_module(mod), fn)(**spec["kwargs"])
    torch.save(result, os.path.join(spec["out"], f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
