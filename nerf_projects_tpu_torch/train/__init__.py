from nerf_projects_tpu_torch.train.nerf_sh_trainer import NeRFSHTrainer, SHTrainState
from nerf_projects_tpu_torch.train.nerf_trainer import NeRFTrainer, TrainState
from nerf_projects_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainer, RMSState
from nerf_projects_tpu_torch.train.schedules import exponential_decay, log_linear_decay

__all__ = ["NeRFSHTrainer", "NeRFTrainer", "SHTrainState", "PlenoxelsTrainer", "RMSState", "TrainState", "exponential_decay", "log_linear_decay"]
