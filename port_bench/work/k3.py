"""K3, the Plenoxels tile march (``ops/kernels/tile_march.py::tile_march_fwd``,
``csrc/tile_march_fwd.cu``): its operations and bytes a launch, from
counts of the work that these inputs need (``reference/plenoxels.py::
march_counts``), as ``chip_smoke.py::march_bound`` counts them.

Operations (float32, an FMA counts two): 50 a sample whose lower corner
lies in a brick that can read data (its step, position, corner weights,
eight density taps, threshold, transmittance); 19 a run of samples in a
brick that cannot (one brick step of the empty-space skip); and a shaded
sample's colour: eight corners of 3B SH taps, the 3B dot with the tile's
basis, the bias activation and the composite. Bytes: each touched
brick's live channels (1 + 3B bf16 a cell), each ray's pack (12 float32)
and outputs (8 float32), and each tile's basis once.
"""

NAMES = ("march_kernel",)
PEAK = "fp32_flops_s"
PACK = 12
FLOPS_PER_SAMPLE = 50
FLOPS_PER_BRICK_STEP = 19


def flops_per_shaded(basis_dim: int) -> int:
    return 8 * 2 * 3 * basis_dim + 2 * 3 * basis_dim + 6 + 15


def work(counts: dict, basis_dim: int, n_rays: int, n_tiles: int) -> tuple:
    """(operations, bytes) of one march with ``counts`` (reach,
    brick_steps, shaded, touched)."""
    nbytes = (counts["touched"] * 512 * (1 + 3 * basis_dim) * 2 + n_rays * (PACK + 8) * 4
              + n_tiles * basis_dim * 4)
    flops = (counts["reach"] * FLOPS_PER_SAMPLE + counts["brick_steps"] * FLOPS_PER_BRICK_STEP
             + counts["shaded"] * flops_per_shaded(basis_dim))
    return flops, nbytes
