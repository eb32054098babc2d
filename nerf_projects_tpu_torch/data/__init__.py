from nerf_projects_tpu_torch.data.synthetic import (
    SphereScene,
    default_scene,
    make_dataset,
    ray_batches,
    render_scene,
    scene_fields,
    tile_batches,
)

__all__ = [
    "SphereScene",
    "default_scene",
    "make_dataset",
    "ray_batches",
    "render_scene",
    "scene_fields",
    "tile_batches",
]
