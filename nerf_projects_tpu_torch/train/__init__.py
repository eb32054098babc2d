from nerf_projects_tpu_torch.train.nerf_trainer import NeRFTrainer, TrainState
from nerf_projects_tpu_torch.train.schedules import exponential_decay, log_linear_decay

__all__ = ["NeRFTrainer", "TrainState", "exponential_decay", "log_linear_decay"]
