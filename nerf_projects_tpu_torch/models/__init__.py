from nerf_projects_tpu_torch.models.nerf import NeRFMLP, flax_to_state_dict
from nerf_projects_tpu_torch.models.nerf_sh import CondMLP, NeRFSHModel, nerf_sh_flax_to_state_dict
from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig, render_rays
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid

__all__ = ["CondMLP", "NeRFMLP", "NeRFSHModel", "NeRFRenderConfig", "SparseGrid", "flax_to_state_dict", "nerf_sh_flax_to_state_dict", "render_rays"]
