from nerf_projects_tpu_torch.models.nerf import NeRFMLP, flax_to_state_dict
from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig, render_rays
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid

__all__ = ["NeRFMLP", "NeRFRenderConfig", "SparseGrid", "flax_to_state_dict", "render_rays"]
