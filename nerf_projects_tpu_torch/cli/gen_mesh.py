"""Mesh-extraction CLI (port of ``nerf_projects_tpu/cli/gen_mesh.py``;
reference plenoctree/nerf_sh/gen_mesh.py): a NeRF-SH run's density
(``--kind nerf_sh``, restored as ``octree_tools`` restores it) or a
Plenoxels grid's (``--kind grid``, an svox2-schema npz) sampled on a
dense grid, its isosurface written as an OBJ.

    python -m nerf_projects_tpu_torch.cli.gen_mesh RUN_DIR --out mesh.obj [--kind grid] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description="Extract an isosurface OBJ")
    p.add_argument("ckpt", help="NeRF-SH train_dir or Plenoxels grid npz")
    p.add_argument("--out", required=True)
    p.add_argument("--kind", choices=["nerf_sh", "grid"], default="nerf_sh")
    p.add_argument("--reso", type=int, default=256)
    p.add_argument("--radius", type=float, default=1.5)
    p.add_argument("--iso", type=float, default=25.0)
    p.add_argument("--chunk", type=int, default=65536)
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    from nerf_projects_tpu_torch.core.device import resolve_device
    from nerf_projects_tpu_torch.pipeline.mesh import extract_mesh_from_field, save_obj

    dev = resolve_device(args.device)
    if args.kind == "nerf_sh":
        from nerf_projects_tpu_torch.cli.octree_tools import _load_model

        _, model = _load_model(argparse.Namespace(train_dir=args.ckpt, data_dir=None, config=None), dev)

        def sigma_fn(pts):
            return torch.relu(model.eval_points_raw(pts)[1][:, 0])
    else:
        from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
        from nerf_projects_tpu_torch.ops.grid import sample_grid

        grid = SparseGrid.load(args.ckpt, device=dev)

        def sigma_fn(pts):
            return torch.relu(sample_grid(grid, pts, want_colors=False)[0][:, 0])

    verts, tris = extract_mesh_from_field(sigma_fn, reso=args.reso, radius=args.radius, iso=args.iso,
                                          chunk=args.chunk, device=dev)
    save_obj(args.out, verts, tris)
    print(f"{args.out}: {len(verts)} vertices, {len(tris)} triangles")
    return verts, tris


if __name__ == "__main__":
    main()
