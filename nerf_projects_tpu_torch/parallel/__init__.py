from nerf_projects_tpu_torch.parallel.mesh import (
    RAY_AXIS,
    init_distributed,
    make_mesh,
    replicate,
    shard_rays,
)

__all__ = ["make_mesh", "shard_rays", "replicate", "RAY_AXIS", "init_distributed"]
