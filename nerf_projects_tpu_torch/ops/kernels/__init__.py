"""Hand-written Hopper kernels, one module per Pallas file of
``nerf_projects_tpu/ops/pallas/``; each keeps its plain PyTorch version
beside it."""
