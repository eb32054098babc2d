"""The port's Plenoxels render CLI end to end on the CPU: a Blender scene
written on the fly, a grid saved by the JAX package, and
``cli/render_imgs.py`` through its default (fast) route, ``--exact``,
``--tiles`` and ``--frame``, against the JAX package's exact render of the
same views."""
import json
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.cli import render_imgs as jri
from nerf_projects_tpu.cli.train_plenoxels import _to_opencv_pose as jax_to_opencv_pose
from nerf_projects_tpu.data.base import detect_dataset_type as jax_detect
from nerf_projects_tpu.data.base import load_scene as jax_load_scene
from nerf_projects_tpu.models.sparse_grid import SparseGrid as JaxSparseGrid
from nerf_projects_tpu.ops.grid import GridRenderOptions as JaxOptions
from nerf_projects_tpu_torch.cli import render_imgs as tri
from nerf_projects_tpu_torch.core.rays import pose_spherical
from nerf_projects_tpu_torch.data.base import detect_dataset_type, load_scene
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
from tests.test_data import llff_root  # noqa: F401

SIZE = 24


def make_blender_scene(root, n_train=2, n_test=2, size=SIZE):
    """A Blender-format scene of random RGBA images around the origin."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(0)
    for split, cnt in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(cnt):
            img = rng.uniform(size=(size, size, 4))
            imageio.imwrite(os.path.join(root, split, f"r_{i}.png"), (img * 255).astype(np.uint8))
            pose = pose_spherical(i * 60.0 + 15.0, -30.0, 2.6)
            frames.append({"file_path": f"{split}/r_{i}", "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)


@pytest.fixture(scope="module")
def scene_and_grid(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("blender"))
    make_blender_scene(root)
    rng = np.random.default_rng(1)
    jg = JaxSparseGrid.create(16, basis_dim=4, use_sphere_bound=True)
    dens = rng.uniform(0.0, 8.0, (jg.capacity, 1)).astype(np.float32)
    sh = (rng.standard_normal((jg.capacity, 12)) * 0.3).astype(np.float16).astype(np.float32)
    jg = replace(jg, density_data=jnp.asarray(dens), sh_data=jnp.asarray(sh))
    ckpt = os.path.join(root, "grid.npz")
    jg.save(ckpt)
    return root, ckpt


def test_blender_loader_matches_jax(scene_and_grid, llff_root):
    root, _ = scene_and_grid
    assert detect_dataset_type(root) == jax_detect(root) == "blender"
    for split in ("train", "test"):
        got, want = load_scene(root, split), jax_load_scene(root, split)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.poses, want.poses)
        np.testing.assert_array_equal(got.intrinsics, want.intrinsics)
        np.testing.assert_allclose(got.render_poses, want.render_poses, rtol=0, atol=0)
        assert (got.near, got.far, got.white_bkgd, got.meta) == (want.near, want.far, want.white_bkgd, want.meta)
        np.testing.assert_array_equal(tri._to_opencv_pose(got.poses[0], got),
                                      jax_to_opencv_pose(want.poses[0], want))
    # load_scene dispatches beyond Blender: an LLFF root loads as the JAX package loads it
    assert detect_dataset_type(llff_root) == jax_detect(llff_root) == "llff"
    got, want = load_scene(llff_root, factor=1), jax_load_scene(llff_root, factor=1)
    for name in ("images", "poses", "intrinsics", "render_poses"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.near, got.far, got.ndc) == (want.near, want.far, want.ndc) == (0.0, 1.0, True)


def test_exact_route_matches_the_jax_render(scene_and_grid):
    """The default route renders a view exactly as the JAX package's
    exact render of the JAX-loaded grid (float32 on both sides)."""
    root, ckpt = scene_and_grid
    scene = load_scene(root, "test")
    want = jri.render_grid_image(JaxSparseGrid.load(ckpt), jax_load_scene(root, "test"), 1, JaxOptions(),
                                 chunk=SIZE * SIZE)
    got = tri.render_grid_image(SparseGrid.load(ckpt, device="cpu"), scene, 1, GridRenderOptions(), chunk=100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


def test_cli_routes_on_the_cpu(scene_and_grid, tmp_path, capsys):
    """main() through the default (fast) route, --exact, --tiles and
    --frame on device="cpu": metrics JSON, saved renders; the frame and
    tile march renders agree with each other and stay near the exact
    render (they march from each tile's least entry with the tile's
    basis), and so does the fast route."""
    root, ckpt = scene_and_grid
    means, images = {}, {}
    for route in ("default", "exact", "tiles", "frame"):
        out = tmp_path / route
        flags = [] if route == "default" else [f"--{route}"]
        tri.main([ckpt, root, "--device", "cpu", "--out_dir", str(out), "--n_images", "2", *flags])
        means[route] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert os.path.isfile(out / "metrics.json") and os.path.isfile(out / "0001.png")
        assert np.isfinite(means[route]["psnr"])
    scene = load_scene(root, "test")
    grid = SparseGrid.load(ckpt, device="cpu")
    from nerf_projects_tpu_torch.ops.brick_grid import from_sparse_grid
    from nerf_projects_tpu_torch.ops.kernels import tile_march as ttm

    bg = from_sparse_grid(grid)
    ka = ttm.build_kernel_arrays(bg)
    opts = GridRenderOptions()
    C = ttm.default_chunks_for(bg, opts)
    frame = tri.render_grid_image_frame(ttm.geometry_only(bg), ka, scene, 0, opts, C)
    tiles = tri.render_grid_image_tiles(ttm.geometry_only(bg), ka, C, scene, 0, opts)
    exact = tri.render_grid_image(grid, scene, 0, opts)
    assert frame.shape == (SIZE, SIZE, 3)
    np.testing.assert_allclose(frame.numpy(), tiles.numpy(), rtol=1e-5, atol=1e-5)
    assert float((frame - exact).abs().mean()) < 2e-2
    assert abs(means["frame"]["psnr"] - means["exact"]["psnr"]) < 0.5
    assert abs(means["default"]["psnr"] - means["exact"]["psnr"]) < 0.5
    tri.main([ckpt, root, "--device", "cpu", "--frame", "--timing", "--n_images", "1"])
    timing = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert timing["fps"] > 0 and timing["device"] == "cpu"
    with pytest.raises(NotImplementedError, match="max_windows"):
        tri.main([ckpt, root, "--device", "cpu", "--frame", "--max_windows", "2", "--n_images", "1"])
