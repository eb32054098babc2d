"""nerf_projects_tpu_torch — the PyTorch/CUDA port of nerf_projects_tpu.

The JAX package beside it is the reference; this package mirrors its
paths (``core/rays.py`` here ports ``nerf_projects_tpu/core/rays.py``)
and imports nothing of it. Plain tensor code is PyTorch; each Pallas
kernel on a ported path becomes a CUDA kernel written for Hopper
(``csrc/``), wrapped at the counterpart path of its Pallas file
(``ops/kernels/`` for ``ops/pallas/``).

Entry points take ``device=None``, meaning ``cuda``, and raise when no
card is present; pass ``device="cpu"`` to run on the host.
"""

__version__ = "0.1.0"
