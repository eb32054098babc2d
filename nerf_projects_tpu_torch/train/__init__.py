from nerf_projects_tpu_torch.train.nerf_trainer import NeRFTrainer

__all__ = ["NeRFTrainer"]
