"""Shared fixtures of the benchmark's CPU tests, and the ``card`` marker
of the tests that need an NVIDIA card (they skip without one; run them on
the card with ``python -m pytest port_bench/tests -m card``)."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips on a machine without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided inside the fixture, so
    every worker collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


SMALL = {
    "plenoxels_frames": lambda c, t: (c.update(reso=[64, 64, 64]),
                                      t["camera"].update(width=64, height=64, focal=64.0, poses=4),
                                      t["check"].update(first_frames=2, frame_every=3, max_frames=4, tiles_per_frame=4),
                                      t.update(count_poses=[0, 2])),
    "nerf_train": lambda c, t: (c.update(N_rand=64), t["pool"].update(views=2, width=16, height=16),
                                t.update(steps_per_call=2)),
    "plenoxels_train": lambda c, t: (c.update(reso=[64, 64, 64], batch_size=256, max_touched=4096),
                                     t["pool"].update(views=2, width=32, height=32)),
    "nerf_frames": lambda c, t: (c.update(H=16, W=16, chunk=96), t["orbit"].update(poses=2),
                                 t["check"].update(rays_per_frame=32, max_frames=4)),
}


def shrink(spec):
    """The cell at a size the CPU holds in seconds: the same code paths,
    widths and traffic kinds, fewer cells, rays and views."""
    spec = copy.deepcopy(spec)
    SMALL[spec.traffic["driver"]](spec.config, spec.traffic)
    return spec


@pytest.fixture
def small_spec():
    from port_bench import harness

    return lambda name: shrink(harness.load_spec(name))
