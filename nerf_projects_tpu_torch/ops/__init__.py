from nerf_projects_tpu_torch.ops.posenc import posenc, posenc_dim
from nerf_projects_tpu_torch.ops.render import (
    RenderOutputs,
    compute_alpha_weights,
    volumetric_rendering,
)
from nerf_projects_tpu_torch.ops.sampling import (
    cast_rays,
    merge_sorted,
    piecewise_constant_pdf,
    sample_pdf,
    sorted_uniform,
    stratified_sample,
)

__all__ = [
    "RenderOutputs",
    "cast_rays",
    "compute_alpha_weights",
    "merge_sorted",
    "piecewise_constant_pdf",
    "posenc",
    "posenc_dim",
    "sample_pdf",
    "sorted_uniform",
    "stratified_sample",
    "volumetric_rendering",
]
