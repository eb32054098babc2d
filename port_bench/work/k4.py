"""K4, the Plenoxels march's backward (``ops/kernels/tile_march.py::tile_march_bwd``,
``csrc/tile_march_bwd.cu``): its operations and bytes a launch, as
``chip_smoke.py::march_bwd_bound`` counts them, from counts of the work
these inputs need (``reference/plenoxels.py::march_counts`` with early
stop: the backward ends each ray at its first inactive sample).

Operations: the re-march as K3's (``work/k3.py``) and, on a shaded
sample, the backward's own: c . g 5, w (c . g) and the running sum 2, the
transmittance terms 4, g_sigma 2, g_rgb 6, then per corner its density
and colour terms 5 and the 3B products with the basis and their adds 6B.
Bytes: the touched bricks' live channels read once (1 + 3B bf16 a cell)
and their float32 gradient rows written once, each ray's pack, g and S
read once and each tile's basis. (``chip_smoke.py`` counted the whole
gradient arrays, which the wrapper's zero fill writes before the
kernel; the fill is not the kernel's work, and its time is not in
``march_bwd_kernel``'s.)
"""

from port_bench.work import k3

NAMES = ("march_bwd_kernel",)
PEAK = "fp32_flops_s"


def bwd_flops_per_shaded(basis_dim: int) -> int:
    return 5 + 2 + 4 + 2 + 6 + 8 * (2 + 3 + 6 * basis_dim)


def work(counts: dict, basis_dim: int, n_rays: int, n_tiles: int) -> tuple:
    """(operations, bytes) of one backward with ``counts`` (reach,
    brick_steps, shaded, touched)."""
    B = basis_dim
    nbytes = (counts["touched"] * 512 * (1 + 3 * B) * (2 + 4)
              + n_rays * (k3.PACK + 3 + 1) * 4 + n_tiles * B * 4)
    flops = (counts["reach"] * k3.FLOPS_PER_SAMPLE + counts["brick_steps"] * k3.FLOPS_PER_BRICK_STEP
             + counts["shaded"] * (k3.flops_per_shaded(B) + bwd_flops_per_shaded(B)))
    return flops, nbytes
