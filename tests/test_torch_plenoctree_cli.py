"""The port's PlenOctree CLIs on the CPU against the JAX package's:
``cli/octree_tools.py``'s five commands, ``cli/gen_mesh.py`` of both kinds
and ``cli/full_pipeline.py``'s stages.

One narrow NeRF-SH run directory (flags.json and checkpoint.pt, the
port's format) holds flax-initialised weights with random biases; JAX's
commands get the same model through a patched ``_load_model`` and the
same scene through a patched ``load_scene`` (the port's commands take it
by keyword). Saved trees within a float16 step (the same topology),
compressed files and
parsers' defaults equal, PSNRs within 1e-3 dB, the pipeline's command
lines equal but for the package's name.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_projects_tpu.cli.full_pipeline as jfp
import nerf_projects_tpu.cli.gen_mesh as jgm
import nerf_projects_tpu.cli.octree_tools as jot
import nerf_projects_tpu.data.base as jbase
from nerf_projects_tpu.cli.nerf_sh_flags import NeRFSHFlags as JFlags, build_model as jbuild
from nerf_projects_tpu.core.rays import Rays as JRays
from nerf_projects_tpu.models.octree import PlenOctree as JTree
from nerf_projects_tpu.models.sparse_grid import SparseGrid as JGrid
from nerf_projects_tpu_torch.cli import full_pipeline as tfp
from nerf_projects_tpu_torch.cli import gen_mesh as tgm
from nerf_projects_tpu_torch.cli import octree_tools as tot
from nerf_projects_tpu_torch.cli.nerf_sh_flags import NeRFSHFlags, build_model
from nerf_projects_tpu_torch.models.nerf_sh import nerf_sh_flax_to_state_dict
from nerf_projects_tpu_torch.models.octree import PlenOctree as TTree
from nerf_projects_tpu_torch.train.checkpoint import save_checkpoint
from nerf_projects_tpu_torch.train.nerf_sh_trainer import NeRFSHTrainer
from tests.test_torch_fused_mlp import random_biases
from tests.test_torch_plenoctree_pipeline import scenes
from tests.test_torch_tile_march import random_grids

SMALL = dict(sh_deg=1, use_viewdirs=False, num_coarse_samples=4, num_fine_samples=4, net_depth=2, net_width=32,
             max_deg_point=4)
TOL = 1e-5
F16_STEP = 2.0**-10  # a saved tree's data is float16: float32 values 1e-7 apart may round a step apart
PSNR_ATOL = 1e-3
EVAL = ["--renderer_step_size", "1e-2", "--chunk", "200"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The run directory, both models and the scene pair (2 views of 16^2);
    JAX's tree extracted by its CLI into ``jax.npz``."""
    d = tmp_path_factory.mktemp("run")
    flags = NeRFSHFlags(train_dir=str(d), **SMALL)
    jmodel = jbuild(JFlags(**SMALL))
    rays = JRays(*(jnp.asarray(np.eye(3, dtype=np.float32)[:2]) for _ in range(3)))
    k = jax.random.split(jax.random.PRNGKey(5), 3)
    params = jax.jit(lambda a, b, c, r: jmodel.init(a, b, c, r, False))(k[0], k[1], k[2], rays)
    params = random_biases(jax.tree_util.tree_map(np.asarray, params), 5, std=0.5)
    state = NeRFSHTrainer(build_model(flags), randomized=False, device="cpu").init_state(0)
    state.model.load_state_dict(nerf_sh_flax_to_state_dict(params), strict=True)
    save_checkpoint(str(d / "checkpoint.pt"), state)
    with open(d / "flags.json", "w") as f:
        json.dump(dataclasses.asdict(flags), f)
    scene, jscene = scenes(n_views=2, size=16)
    out = dict(dir=d, jmodel=jmodel, params=jax.tree_util.tree_map(jnp.asarray, params), scene=scene,
               jscene=jscene)
    with pytest.MonkeyPatch.context() as mp:
        patch_jax(mp, out)
        jot.main(["extract", "--train_dir", str(d), "--output", str(d / "jax.npz"), "--autoscale",
                  "--init_grid_depth", "3", "--chunk", "4096"])
    return out


def patch_jax(mp, run):
    """JAX's commands read the run's model and the scene from the fixture."""
    jflags = JFlags(train_dir=str(run["dir"]), **SMALL)
    mp.setattr(jot, "_load_model", lambda args: (jflags, run["jmodel"], run["params"]))
    mp.setattr(jbase, "load_scene", lambda root, split="train", **kw: run["jscene"])


def test_extract_matches_jax(run, capsys):
    out = str(run["dir"] / "port.npz")
    stats = {}
    args = tot.build_parser().parse_args(["extract", "--train_dir", str(run["dir"]), "--output", out, "--autoscale",
                                          "--init_grid_depth", "3", "--chunk", "4096", "--device", "cpu"])
    tot.cmd_extract(args, device="cpu", stats=stats)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got, want = TTree.load(out, device="cpu"), JTree.load(str(run["dir"] / "jax.npz"))
    np.testing.assert_array_equal(got.child_host, np.asarray(want.child))
    np.testing.assert_allclose(got.offset, want.offset, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=F16_STEP, atol=TOL)
    assert printed == {"nodes": got.n_nodes, "leaves": got.n_leaves, "output": out} and got.n_nodes > 9
    assert 0 < stats["masked_share"] < 1


def test_parsers_match_jax(monkeypatch):
    """Each command's flags and defaults, the port's --device aside."""
    seen = {}
    for name in ("cmd_extract", "cmd_optimize", "cmd_evaluate", "cmd_compress", "cmd_compressed_eval"):
        monkeypatch.setattr(jot, name, lambda a, _n=name: seen.__setitem__(_n, vars(a)))
    argv = {"extract": ["--train_dir", "r", "--output", "o"], "optimize": ["--input", "i", "--data_dir", "d"],
            "evaluate": ["--input", "i", "--data_dir", "d"], "compress": ["--input", "i", "--output", "o"],
            "compressed_eval": ["--input", "i", "--data_dir", "d"]}
    parser = tot.build_parser()
    for cmd, rest in argv.items():
        jot.main([cmd] + rest)
        want = {k: v for k, v in seen[f"cmd_{cmd}"].items() if k != "fn"}
        got = {k: v for k, v in vars(parser.parse_args([cmd] + rest)).items() if k not in ("fn", "device")}
        assert got == want, cmd
    assert parser.parse_args(["optimize", "--input", "i", "--data_dir", "d"]).sgd is True


def test_evaluate_both_routes_and_the_log_match_jax(run, tmp_path, monkeypatch, capsys):
    """The exact octree march and --fast (the baked grid's fast route) on
    the scene's first view (JAX compiles its render at every call): the
    JSON file's PSNR within 1e-3 dB of JAX's, and the octree_evaluation
    entry of metrics_log.json."""
    one = dataclasses.replace(run["scene"], images=run["scene"].images[:1], poses=run["scene"].poses[:1])
    jone = dataclasses.replace(run["jscene"], images=run["jscene"].images[:1], poses=run["jscene"].poses[:1])
    patch_jax(monkeypatch, dict(run, jscene=jone))
    tree = str(run["dir"] / "jax.npz")
    for fast in ([], ["--fast"]):
        jdir, tdir = tmp_path / f"j{len(fast)}", tmp_path / f"t{len(fast)}"
        jdir.mkdir()
        tdir.mkdir()
        common = ["evaluate", "--input", tree, "--data_dir", "scene"] + EVAL + fast
        jot.main(common + ["--train_dir", str(jdir), "--output", str(jdir / "eval.json")])
        tot.cmd_evaluate(tot.build_parser().parse_args(common + ["--train_dir", str(tdir), "--output",
                                                                 str(tdir / "eval.json")]),
                         scene=one, device="cpu")
        want, got = (json.load(open(p / "eval.json")) for p in (jdir, tdir))
        assert sorted(got) == sorted(want) and len(got["per_image"]) == 1
        for g, w in zip(got["per_image"], want["per_image"]):
            assert abs(g["psnr"] - w["psnr"]) < PSNR_ATOL, fast
        (jlog,), (tlog,) = (json.load(open(p / "metrics_log.json")) for p in (jdir, tdir))
        assert tlog["phase"] == jlog["phase"] == "octree_evaluation"
        assert sorted(tlog["metrics"]) == sorted(jlog["metrics"]) and "fps" in tlog["additional_info"]
    capsys.readouterr()


def test_optimize_compress_and_compressed_eval_match_jax(run, tmp_path, monkeypatch, capsys):
    """One epoch of SGD (lr 1e2) from JAX's tree, then compress and the
    compressed tree's evaluate: the finetuned trees within 1e-5, the
    compressed files equal, the PSNRs within 1e-3 dB."""
    patch_jax(monkeypatch, run)
    tree = str(run["dir"] / "jax.npz")
    opt = ["--input", tree, "--data_dir", "scene", "--lr", "1e2", "--num_epochs", "1", "--val_interval", "1"] + EVAL
    jot.main(["optimize", "--output", str(tmp_path / "jopt.npz")] + opt)
    jpsnr = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["psnr"]
    _, tpsnr = tot.cmd_optimize(tot.build_parser().parse_args(["optimize", "--output", str(tmp_path / "topt.npz")]
                                                              + opt), train=run["scene"], device="cpu")
    assert abs(tpsnr - jpsnr) < PSNR_ATOL
    got, want = TTree.load(str(tmp_path / "topt.npz"), device="cpu"), JTree.load(str(tmp_path / "jopt.npz"))
    np.testing.assert_array_equal(got.child_host, np.asarray(want.child))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=F16_STEP, atol=TOL)

    comp = ["compress", "--input", str(tmp_path / "jopt.npz"), "--n_colors", "256", "--sigma_thresh", "0.05"]
    jot.main(comp + ["--output", str(tmp_path / "jc.npz")])
    tot.main(comp + ["--output", str(tmp_path / "tc.npz"), "--device", "cpu"])
    zj, zt = np.load(tmp_path / "jc.npz"), np.load(tmp_path / "tc.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k])
    ce = ["compressed_eval", "--input", str(tmp_path / "jc.npz"), "--data_dir", "scene"] + EVAL
    jot.main(ce)
    jce = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tce = tot.cmd_compressed_eval(tot.build_parser().parse_args(ce), scene=run["scene"], device="cpu")
    assert abs(tce["mean"]["psnr"] - jce["psnr"]) < PSNR_ATOL


def _read_obj(path):
    lines = open(path).read().splitlines()
    v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("v ")])
    f = np.array([[int(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("f ")])
    return v, f


def test_gen_mesh_both_kinds_match_jax(run, tmp_path, monkeypatch, capsys):
    """--kind nerf_sh from the run directory and --kind grid from an
    svox2-schema npz: the same triangles, their corners within 1e-5 (the
    float32 fields agree to ~1e-6, not to the bit)."""
    jg, _ = random_grids(12, 1, seed=21)
    grid_path = str(tmp_path / "grid.npz")
    jg.save(grid_path)
    monkeypatch.setattr(jot, "_load_model", lambda ns: (None, run["jmodel"], run["params"]))
    for kind, src, iso in (("nerf_sh", str(run["dir"]), "0.3"), ("grid", grid_path, "3.0")):
        common = [src, "--kind", kind, "--reso", "20", "--radius", "1.2", "--iso", iso, "--chunk", "1000"]
        jgm.main(common + ["--out", str(tmp_path / f"j_{kind}.obj")])
        tgm.main(common + ["--out", str(tmp_path / f"t_{kind}.obj"), "--device", "cpu"])
        (gv, gf), (wv, wf) = _read_obj(tmp_path / f"t_{kind}.obj"), _read_obj(tmp_path / f"j_{kind}.obj")
        assert len(gf) == len(wf) > 20, kind
        # the vertex numbering follows the deduplicated vertices' order, which
        # a last-bit move can change: compare each triangle's corners
        np.testing.assert_allclose(gv[gf - 1], wv[wf - 1], rtol=0, atol=TOL)
    assert JGrid.load(grid_path).reso == (12, 12, 12)
    capsys.readouterr()


class Recorder:
    """subprocess.run stand-in: records each command, fails on ``fail``."""

    def __init__(self, fail=None):
        self.cmds, self.fail = [], fail

    def __call__(self, cmd, capture_output=True, text=True):
        self.cmds.append(list(cmd))
        bad = self.fail is not None and self.fail in cmd
        return subprocess.CompletedProcess(cmd, 1 if bad else 0, stdout="out", stderr="err")


def test_full_pipeline_commands_markers_and_force(tmp_path, monkeypatch, capsys):
    """The five stages' command lines are JAX's with the port's package;
    a second run skips every stage by its .done_ marker, --force reruns
    them, --skip_train leaves training out, a failing stage stops the run
    with its log written and no marker."""
    argv = lambda d: ["--data_dir", "scene", "--train_dir", str(d), "--max_steps", "7", "--sh_deg", "3"]  # noqa: E731
    jrec, trec = Recorder(), Recorder()
    monkeypatch.setattr(subprocess, "run", jrec)  # both modules call subprocess.run
    jfp.main(argv(tmp_path / "j"))
    monkeypatch.setattr(subprocess, "run", trec)
    tfp.main(argv(tmp_path / "t"))
    assert len(trec.cmds) == 5
    for got, want in zip(trec.cmds, jrec.cmds):
        want = [w.replace(str(tmp_path / "j"), str(tmp_path / "t")).replace("nerf_projects_tpu.cli",
                                                                            "nerf_projects_tpu_torch.cli")
                for w in want]
        assert got == want
    assert trec.cmds[0][:3] == [sys.executable, "-m", "nerf_projects_tpu_torch.cli.train_nerf_sh"]
    markers = sorted(p for p in os.listdir(tmp_path / "t") if p.startswith(".done_"))
    assert markers == [".done_" + s for s in sorted(("train", "extract", "optimize", "compress", "evaluate"))]
    assert open(tmp_path / "t" / "extract.log").read() == "out\nerr"
    tfp.main(argv(tmp_path / "t"))
    assert len(trec.cmds) == 5 and capsys.readouterr().out.count("[skip]") == 5
    tfp.main(argv(tmp_path / "t") + ["--force", "--skip_train", "--device", "cpu"])
    assert len(trec.cmds) == 9 and all(c[-2:] == ["--device", "cpu"] for c in trec.cmds[5:])
    bad = Recorder(fail="compress")
    monkeypatch.setattr(subprocess, "run", bad)
    with pytest.raises(SystemExit, match="compress failed"):
        tfp.main(argv(tmp_path / "f") + ["--skip_train"])
    assert not os.path.exists(tmp_path / "f" / ".done_compress") and os.path.exists(tmp_path / "f" / "compress.log")
