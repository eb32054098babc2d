"""The port's video and metrics tools and its floater visualisation on the
CPU against the JAX package: ``pipeline/video.py``, ``cli/gen_video.py``
(a grid, a tree and a NeRF-SH run, 2 poses at 32^2), ``cli/calc_metrics.py``,
``obs/theme.py`` and ``obs/floater_viz.py``.

The same files go to both packages (a grid npz and a tree npz saved by
JAX; a NeRF-SH run directory in the port's format, JAX's commands reading
the same weights through a patched ``_load_model``). Tolerances: frames
written by both CLIs within one level of 255 (float renders ~1e-6 apart
can round to neighbouring bytes); the floater masks, projections and the
figures' pixels equal; the metrics to 1e-6.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_projects_tpu.cli.octree_tools as jot
from nerf_projects_tpu.cli import calc_metrics as jcm
from nerf_projects_tpu.cli import gen_video as jgv
from nerf_projects_tpu.cli.nerf_sh_flags import NeRFSHFlags as JFlags, build_model as jbuild
from nerf_projects_tpu.cli.train_plenoxels import _to_opencv_pose
from nerf_projects_tpu.core.rays import pose_spherical
from nerf_projects_tpu.models.sparse_grid import SparseGrid as JGrid
from nerf_projects_tpu.obs import floater_viz as jfv
from nerf_projects_tpu.obs import theme as jtheme
from nerf_projects_tpu.pipeline.video import render_video as jrender_video
from nerf_projects_tpu_torch.cli import calc_metrics as tcm
from nerf_projects_tpu_torch.cli import gen_video as tgv
from nerf_projects_tpu_torch.cli.nerf_sh_flags import NeRFSHFlags, build_model
from nerf_projects_tpu_torch.data.base import SceneData
from nerf_projects_tpu_torch.models.nerf_sh import nerf_sh_flax_to_state_dict
from nerf_projects_tpu_torch.models.octree import PlenOctree
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.obs import floater_viz as tfv
from nerf_projects_tpu_torch.obs import theme as ttheme
from nerf_projects_tpu_torch.pipeline.video import render_video
from nerf_projects_tpu_torch.train.checkpoint import save_checkpoint
from nerf_projects_tpu_torch.train.nerf_sh_trainer import NeRFSHTrainer
from tests.test_torch_tile_march import random_grids

SMALL = dict(sh_deg=1, use_viewdirs=False, num_coarse_samples=4, num_fine_samples=4, net_depth=2, net_width=32,
             max_deg_point=4)
VIDEO = ["--n_poses", "2", "--width", "32", "--height", "32", "--chunk", "512"]
H = W = 32


def read_png(path):
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Video
# ---------------------------------------------------------------------------

def test_render_video_matches_jax(tmp_path):
    """One render function through both: the same frame files, bytes and
    animation (a GIF where no mp4 writer is)."""
    imgs = np.random.default_rng(0).uniform(size=(3, 8, 8, 3)).astype(np.float32)
    poses = list(range(3))
    jframes, janim = jrender_video(lambda i: imgs[i], poses, str(tmp_path / "j"), fps=5, basename="clip")
    tframes, tanim = render_video(lambda i: torch.from_numpy(imgs[i]), poses, str(tmp_path / "t"), fps=5,
                                  basename="clip")
    assert [os.path.basename(p) for p in tframes] == [os.path.basename(p) for p in jframes]
    assert os.path.basename(tanim) == os.path.basename(janim) and os.path.exists(tanim)
    for a, b in zip(tframes, jframes):
        np.testing.assert_array_equal(read_png(a), read_png(b))
    assert render_video(lambda i: imgs[i], poses, str(tmp_path / "n"), save_frames=False)[0] == []


def nerf_sh_flax_tree(state_dict):
    """A NeRFSHModel state dict -> the flax parameter tree (numpy) whose
    ``nerf_sh_flax_to_state_dict`` it is."""
    p = {}
    for key, v in state_dict.items():
        mlp, _, i, kind = key.split(".")
        leaf = p.setdefault(mlp, {}).setdefault(f"Dense_{i}", {})
        leaf["kernel" if kind == "weight" else "bias"] = v.numpy().T.copy() if kind == "weight" else v.numpy()
    return {"params": p}


@pytest.fixture(scope="module")
def nerf_sh_run(tmp_path_factory):
    """A narrow NeRF-SH run directory (flags.json, checkpoint.pt) with the
    port's seeded weights and random biases, and JAX's model and the same
    parameters for its patched ``_load_model``."""
    d = tmp_path_factory.mktemp("run")
    flags = NeRFSHFlags(train_dir=str(d), **SMALL)
    state = NeRFSHTrainer(build_model(flags), randomized=False, device="cpu").init_state(0)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, v in state.model.named_parameters():
            if name.endswith("bias"):
                v.copy_(torch.from_numpy(rng.normal(0.0, 0.5, tuple(v.shape)).astype(np.float32)))
    params = nerf_sh_flax_tree(state.model.state_dict())
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in nerf_sh_flax_to_state_dict(params).items())
    save_checkpoint(str(d / "checkpoint.pt"), state)
    with open(d / "flags.json", "w") as f:
        json.dump(dataclasses.asdict(flags), f)
    jflags = JFlags(train_dir=str(d), **SMALL)
    jmodel = jbuild(JFlags(**SMALL))
    return dict(dir=str(d), load=lambda args: (jflags, jmodel, jax.tree_util.tree_map(jnp.asarray, params)))


def port_tree(seed, data_dim=13, rounds=3, share=0.35):
    """tests/test_torch_octree.py's random tree with a quiet rim (no
    density in the leaves on the cube's faces, where one rounding decides
    whether a ray's first sample is inside), built in the port."""
    rng = np.random.default_rng(seed)
    tree = PlenOctree.create(data_dim, center=(0.1, -0.05, 0.0), radius=1.2, depth_limit=rounds + 2, device="cpu")
    for _ in range(rounds):
        tree = tree.refine(rng.uniform(size=tree.n_leaves) < share)
    data = rng.standard_normal(tuple(tree.data.shape)).astype(np.float32) * 0.7
    data[..., -1] = rng.uniform(-2.0, 30.0, data.shape[:-1]) * (rng.uniform(size=data.shape[:-1]) > 0.25)
    cells, _, corner, size = tree.leaf_depths_and_corners()
    c = cells[((corner == 0.0) | (corner + size[:, None] == 1.0)).any(-1)]
    data[c[:, 0], c[:, 1], c[:, 2], c[:, 3], -1] = 0.0
    return tree.replace(data=torch.from_numpy(data))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, nerf_sh_run):
    d = tmp_path_factory.mktemp("ckpts")
    jg, _ = random_grids(12, 1, seed=21, dens_hi=3.0)
    jg.save(str(d / "grid.npz"))
    port_tree(seed=4).save(str(d / "tree.npz"))
    return {"grid": str(d / "grid.npz"), "octree": str(d / "tree.npz"), "nerf_sh": nerf_sh_run["dir"]}


@pytest.mark.parametrize("kind", ["grid", "octree", "nerf_sh"])
def test_gen_video_matches_jax(kind, checkpoints, nerf_sh_run, tmp_path, monkeypatch, capsys):
    """Both CLIs on one checkpoint: the same files, frames within one
    level; the port's CLI renders through ``make_renderer`` (its frames,
    recorded, are what the CLI wrote)."""
    monkeypatch.setattr(jot, "_load_model", nerf_sh_run["load"])
    argv = [checkpoints[kind], "--kind", kind, *VIDEO]
    jgv.main(argv + ["--out_dir", str(tmp_path / "j")])
    frames, make = [], tgv.make_renderer

    def recording(args, device):
        render = make(args, device)

        def record(pose):
            frames.append(render(pose))
            return frames[-1]

        return record

    monkeypatch.setattr(tgv, "make_renderer", recording)
    anim = tgv.main(argv + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"])
    capsys.readouterr()
    assert os.path.basename(anim) in os.listdir(tmp_path / "j")
    names = sorted(f for f in os.listdir(tmp_path / "j") if f.endswith(".png"))
    assert names == sorted(f for f in os.listdir(tmp_path / "t") if f.endswith(".png")) and len(names) == 2
    assert len(frames) == len(names)
    for name, frame in zip(names, frames):
        got, want = read_png(tmp_path / "t" / name), read_png(tmp_path / "j" / name)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (kind, name)
        assert frame.shape == (H, W, 3) and torch.isfinite(frame).all()
        np.testing.assert_array_equal((255 * np.clip(frame.numpy(), 0, 1)).astype(np.uint8), got)


def test_calc_metrics_matches_jax(tmp_path, capsys):
    """Renders against a one-view Blender test split, with the grid's MCQ
    and FDR: the same JSON as JAX's CLI."""
    import imageio.v2 as imageio

    root = tmp_path / "scene"
    (root / "test").mkdir(parents=True)
    rng = np.random.default_rng(1)
    img = (rng.uniform(size=(16, 16, 3)) * 255).astype(np.uint8)
    imageio.imwrite(str(root / "test" / "r_0.png"), img)
    meta = {"camera_angle_x": 0.7, "frames": [{"file_path": "test/r_0",
                                               "transform_matrix": pose_spherical(0, -30, 4).tolist()}]}
    for split in ("test", "train"):
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump(meta, f)
    rdir = tmp_path / "renders"
    rdir.mkdir()
    noisy = np.clip(img.astype(int) + rng.integers(-9, 10, img.shape), 0, 255).astype(np.uint8)
    imageio.imwrite(str(rdir / "0000.png"), noisy)
    jg, _ = random_grids(12, 1, seed=3, dens_hi=1.0)
    jg.save(str(tmp_path / "grid.npz"))
    common = [str(rdir), str(root), "--split", "test", "--ckpt", str(tmp_path / "grid.npz")]
    jcm.main(common + ["--out", str(tmp_path / "j.json")])
    tcm.main(common + ["--out", str(tmp_path / "t.json")])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]).keys() == json.loads(printed[-2]).keys()
    want, got = (json.load(open(tmp_path / f)) for f in ("j.json", "t.json"))
    assert got.keys() == want.keys() and got["n_images"] == want["n_images"] == 1
    for k, v in want["mean"].items():
        np.testing.assert_allclose(got["mean"][k], v, rtol=1e-6, atol=1e-6)
    assert got["advanced"] == pytest.approx(want["advanced"], rel=1e-6)


# ---------------------------------------------------------------------------
# Floaters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def floater_grids():
    """A 16^3 grid with a main blob and three floaters (one voxel, two
    voxels, four voxels), in both packages."""
    jg = JGrid.create(16, basis_dim=1, init_density=0.0)
    rng = np.random.default_rng(2)
    dens = np.zeros((16, 16, 16), np.float32)
    ii, jj, kk = np.meshgrid(*(np.arange(16),) * 3, indexing="ij")
    dens[(ii - 8) ** 2 + (jj - 8) ** 2 + (kk - 7) ** 2 <= 12] = 2.0
    dens[1, 1, 1] = 1.0
    dens[13, 13, 2:4] = 0.5
    dens[2, 13, 12:14] = dens[3, 13, 12:14] = 0.8
    links = np.asarray(jg.links)
    flat = np.zeros((jg.capacity, 1), np.float32)
    flat[links[links >= 0], 0] = dens[links >= 0]
    sh = (rng.standard_normal((jg.capacity, 3)) * 0.3).astype(np.float32)
    jg = dataclasses.replace(jg, density_data=jnp.asarray(flat), sh_data=jnp.asarray(sh))
    tg = SparseGrid.from_numpy(links, flat, sh, jg.radius, jg.center, 1, device="cpu")
    return jg, tg


def camera():
    pose = _to_opencv_pose(pose_spherical(30.0, -30.0, 2.5), SceneData(
        images=np.zeros((1, H, W, 3), np.float32), poses=np.zeros((1, 4, 4)), intrinsics=np.eye(3), near=0.1,
        far=5.0))
    K = np.array([[W * 1.1, 0, W / 2], [0, W * 1.1, H / 2], [0, 0, 1]], np.float32)
    return pose, K


KW = dict(threshold=0.1, min_object_size=10)


def test_floater_masks_match_jax(floater_grids):
    jg, tg = floater_grids
    for kw in (KW, dict(threshold=0.6, min_object_size=10, connectivity=6)):
        for got, want in zip(tfv.floater_masks(tg, return_labels=True, **kw),
                             jfv.floater_masks(jg, return_labels=True, **kw)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    occ, floater = tfv.floater_masks(tg, **KW)
    assert floater.sum() == 7 and occ.sum() > floater.sum()


def test_floater_projections_and_overlays_match_jax(floater_grids):
    jg, tg = floater_grids
    pose, K = camera()
    rgb = np.random.default_rng(3).uniform(size=(H, W, 3)).astype(np.float32)
    _, floater = jfv.floater_masks(jg, **KW)
    want = jfv.project_floaters_to_view(jg, floater, pose, K, H, W)
    got = tfv.project_floaters_to_view(tg, floater, pose, K, H, W)
    assert want is not None and want.sum() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfv.overlay_on_render(rgb, got), jfv.overlay_on_render(rgb, want))
    assert tfv.project_floaters_to_view(tg, np.zeros_like(floater), pose, K, H, W) is None
    for reduce in ("max", "sum"):
        np.testing.assert_array_equal(tfv.render_density_projection(tg, pose, K, H, W, reduce=reduce),
                                      jfv.render_density_projection(jg, pose, K, H, W, reduce=reduce))
    np.testing.assert_array_equal(tfv.component_overlay(rgb, tg, pose, K, **KW),
                                  jfv.component_overlay(rgb, jg, pose, K, **KW))


def test_floater_figures_and_theme_match_jax(floater_grids, tmp_path):
    """The slice PNGs and the panel figure: the same files and pixels
    (matplotlib draws the same arrays the same way); the theme's colours
    and formats."""
    jg, tg = floater_grids
    jpaths = jfv.render_floater_slices(jg, str(tmp_path / "j"), n_slices=2, **KW)
    tpaths = tfv.render_floater_slices(tg, str(tmp_path / "t"), n_slices=2, **KW)
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    jpaths.append(jfv.floater_panel(jg, str(tmp_path / "j" / "panel.png"), n_slices=2, **KW))
    tpaths.append(tfv.floater_panel(tg, str(tmp_path / "t" / "panel.png"), n_slices=2, **KW))
    for a, b in zip(tpaths, jpaths):
        np.testing.assert_array_equal(read_png(a), read_png(b))
    for name in ("lego", "LEGO", "ship"):
        assert ttheme.get_scene_color(name) == jtheme.get_scene_color(name)
    for m in ("psnr", "unknown"):
        assert ttheme.get_metric_color(m) == jtheme.get_metric_color(m)
        assert ttheme.get_stage_color(m) == jtheme.get_stage_color(m)
    for v in (None, 0, 123.456, 7.891, -0.01234):
        assert ttheme.sig3(v) == jtheme.sig3(v)
    assert ttheme.RC_PARAMS == jtheme.RC_PARAMS and ttheme.PALETTE == jtheme.PALETTE


class Recorder:
    """A SummaryWriter stand-in that keeps what is logged."""

    def __init__(self, *a, **k):
        self.calls = []

    def scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, float(value), int(step)))

    def image(self, tag, img, step):
        self.calls.append(("image", tag, np.asarray(img, np.float32), int(step)))

    def histogram(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def assert_same_log(got, want):
    assert [c[:2] + c[3:] for c in got] == [c[:2] + c[3:] for c in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[2], w[2], rtol=1e-6, atol=1e-6)


def test_log_floater_visualizations_matches_jax(floater_grids):
    jg, tg = floater_grids
    pose, K = camera()
    cams = [(pose, K, H, W), (pose, K, H, W)]
    renders = [np.full((H, W, 3), 0.5, np.float32)] * 2
    jrec, trec = Recorder(), Recorder()
    nj = jfv.log_floater_visualizations(jrec, jg, 7, cameras=cams, renders=renders, gt_images=renders, **KW)
    nt = tfv.log_floater_visualizations(trec, tg, 7, cameras=cams, renders=renders, gt_images=renders, **KW)
    assert nt == nj > 3
    assert_same_log(trec.calls, jrec.calls)
