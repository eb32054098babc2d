"""Wall-clock timing context manager and profiler traces (port of
``nerf_projects_tpu/utils/timing.py``).

Parity target: reference svox2/svox2/utils.py:611-632 `Timing` (CUDA
events): here a device-synchronizing timer, ``torch.cuda.synchronize``
on both edges when a card is present (the host clock alone otherwise).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from nerf_projects_tpu_torch.obs import trace


class Timing:
    """with Timing("name"): ...  -> prints elapsed ms (device-synced)."""

    def __init__(self, name: str = "", *, sync: bool = True, silent: bool = False):
        self.name = name
        self.sync = sync
        self.silent = silent
        self.elapsed_ms = None

    def _sync(self):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1000.0
        if not self.silent:
            print(f"{self.name}: {self.elapsed_ms:.3f} ms")
        return False


@contextlib.contextmanager
def profiler_trace(trace_dir: str | None, *, host_tracer_level: int = 2):
    """Capture a ``torch.profiler`` trace (the card's kernels through
    CUPTI when a card is present, the host's ops always) of the enclosed
    block into ``trace_dir`` as a Chrome trace (``trace.json``) and a
    table of the kernels' times (``key_averages.txt``): the reference's
    nvprof/pyprof capture (svox2/test/prof.py:1-40). A no-op when
    ``trace_dir`` is falsy, so trainers can thread a CLI flag straight
    through. The program's own spans and counters (``obs/trace.py``) are
    recorded over the same block and summed by name into ``spans.txt``:
    count, host ms, host self ms and device ms a span, then the counters.
    ``host_tracer_level`` (the TPU tracer's detail) is accepted and
    ignored."""
    del host_tracer_level
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        trace.start()
        try:
            yield
        finally:
            recording = trace.stop()
    with open(os.path.join(trace_dir, "spans.txt"), "w") as f:
        f.write(recording.table())
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    with open(os.path.join(trace_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total" if torch.cuda.is_available()
                                          else "self_cpu_time_total", row_limit=40))
