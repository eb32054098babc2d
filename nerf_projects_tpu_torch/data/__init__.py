from nerf_projects_tpu_torch.data.base import SceneData, detect_dataset_type, load_scene
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
    "SceneData",
    "detect_dataset_type",
    "load_scene",
    "SphereScene",
    "default_scene",
    "make_dataset",
    "ray_batches",
    "render_scene",
    "scene_fields",
    "tile_batches",
]
