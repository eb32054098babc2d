"""The benchmark of the PyTorch and CUDA port (``nerf_projects_tpu_torch``)."""
