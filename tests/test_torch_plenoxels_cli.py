"""The port's Plenoxels CLI (``cli/train_plenoxels.py``) and what it logs
and reads (``obs/json_logger.py``, ``obs/memory_tracker.py``,
``obs/tb.py``, ``obs/advanced_metrics.py``, ``utils/config.py``,
``utils/timing.py``) on the CPU, against the JAX package: the parser's
arguments and defaults, the schedule, every ``--step_mode`` through an
upsample, the JSON config merge, the logs' keys, the metrics and a
checkpoint that the JAX package reads back."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.cli import train_plenoxels as jcli
from nerf_projects_tpu.models.sparse_grid import SparseGrid as JaxSparseGrid
from nerf_projects_tpu.obs import advanced_metrics as jam
from nerf_projects_tpu.obs import json_logger as jlog
from nerf_projects_tpu.obs import memory_tracker as jmem
from nerf_projects_tpu.utils import config as jcfg
from nerf_projects_tpu_torch.cli import train_plenoxels as tcli
from nerf_projects_tpu_torch.data.base import SceneData
from nerf_projects_tpu_torch.data.synthetic import make_dataset
from nerf_projects_tpu_torch.obs import advanced_metrics as tam
from nerf_projects_tpu_torch.obs import json_logger as tlog
from nerf_projects_tpu_torch.obs import memory_tracker as tmem
from nerf_projects_tpu_torch.obs.tb import SummaryWriter
from nerf_projects_tpu_torch.utils import config as tcfg
from nerf_projects_tpu_torch.utils.timing import Timing, profiler_trace
from tests.test_torch_tile_march import np_, random_grids


@pytest.fixture(scope="module")
def scene():
    ds = make_dataset(n_views=4, image_size=24, device="cpu")
    return SceneData(images=np_(ds["images"]), poses=np.asarray(ds["poses"]), intrinsics=ds["intrinsics"],
                     near=ds["near"], far=ds["far"])


def cli_args(tmp_path, *extra):
    return tcli.build_parser().parse_args([
        "--train_dir", str(tmp_path / "ckpt"), "--reso", "[[16,16,16],[24,24,24]]", "--upsamp_every", "3",
        "--n_iters", "4", "--batch_size", "128", "--lr_sigma", "3.0", "--lr_sigma_delay_steps", "0", "--lr_sh", "0.1",
        "--sh_dim", "1", "--thresh_type", "sigma", "--density_thresh", "0.0", "--print_every", "2",
        "--device", "cpu", *extra])


def test_parser_matches_jax():
    """Every argument of JAX's parser with its default, plus --device
    (the card by default)."""
    want = vars(jcli.build_parser().parse_args([]))
    got = vars(tcli.build_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    jactions = {a.dest: a for a in jcli.build_parser()._actions}
    for a in tcli.build_parser()._actions:
        if a.dest in jactions:
            assert (a.option_strings, a.choices, a.type, a.nargs) == (
                jactions[a.dest].option_strings, jactions[a.dest].choices, jactions[a.dest].type,
                jactions[a.dest].nargs), a.dest


@pytest.mark.parametrize("argv", [[], ["--n_iters", "20000"], ["--n_iters", "7", "--lr_sigma_delay_steps", "3"],
                                  ["--lr_sh_decay_steps", "11", "--lr_sigma_decay_steps", "5"]])
def test_resolve_schedule_matches_jax(argv):
    want = vars(jcli.resolve_schedule(jcli.build_parser().parse_args(argv)))
    got = vars(tcli.resolve_schedule(tcli.build_parser().parse_args(argv)))
    got.pop("device")
    assert got == want


@pytest.mark.parametrize("mode", ["cell", "tiles", "sparse", "touched", "flat"])
def test_run_every_step_mode_through_an_upsample(tmp_path, scene, mode):
    """A few steps, one upsample (the grid materialised and the state
    rebuilt), the final eval and the artifacts (TestPlenoxelsCli's)."""
    args = cli_args(tmp_path, "--step_mode", mode, "--log_fdr")
    grid, trainer, result = tcli.run(args, scene=scene, test_scene=scene)
    assert grid.reso == (24, 24, 24) and grid.device.type == "cpu"
    assert trainer.lambda_tv == 0.0  # tv_early_only after the upsample
    for name in ("ckpt.npz", "time_mins.txt", "test_psnr.txt", "args.json", "metrics_log.json"):
        assert os.path.exists(os.path.join(args.train_dir, name)), name
    assert np.isfinite(result["psnr"]) and result["psnr"] > 5 and "FDR" in result and "MCQ" in result
    entries = json.load(open(os.path.join(args.train_dir, "metrics_log.json")))
    assert [e["phase"] for e in entries] == ["training", "training", "evaluation"]
    assert {"loss", "mse", "psnr", "learning_rate"} <= set(entries[0]["metrics"])


def test_touched_mode_on_the_weight_mask_and_a_profile(tmp_path, scene):
    """The default thresh_type (the cameras' largest ray weight), the
    dense sweep turned off, and a profiler window of two steps."""
    args = cli_args(tmp_path, "--step_mode", "touched", "--thresh_type", "weight", "--weight_thresh", "0.05",
                    "--dense_optim", "0", "--profile_dir", str(tmp_path / "prof"), "--profile_steps", "2")
    grid, _, result = tcli.run(args, scene=scene, test_scene=scene)
    assert grid.reso == (24, 24, 24) and 0 < grid.capacity <= 24**3 and np.isfinite(result["psnr"])
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    assert "ProfilerStep" in open(tmp_path / "prof" / "key_averages.txt").read() or os.path.getsize(
        tmp_path / "prof" / "key_averages.txt") > 0


def test_checkpoint_reads_back_in_the_jax_package(tmp_path, scene):
    grid, _, _ = tcli.run(cli_args(tmp_path, "--step_mode", "touched", "--n_iters", "2"), scene=scene,
                          test_scene=scene)
    back = JaxSparseGrid.load(str(tmp_path / "ckpt" / "ckpt.npz"))
    np.testing.assert_array_equal(np.asarray(back.links), np_(grid.links))
    np.testing.assert_array_equal(np.asarray(back.density_data), np_(grid.density_data))
    np.testing.assert_array_equal(np.asarray(back.sh_data), np_(grid.sh_data).astype(np.float16).astype(np.float32))
    assert back.basis_dim == grid.basis_dim == 1
    np.testing.assert_array_equal(back.radius, grid.radius)


def test_json_config_merge(tmp_path, scene):
    cfg = tmp_path / "syn.json"
    cfg.write_text(json.dumps({"n_iters": 3, "batch_size": 128, "sh_dim": 1, "lr_sigma": 3.0,
                               "lr_sigma_delay_steps": 0, "_comment": "ignored"}))
    argv = ["--train_dir", str(tmp_path / "c2"), "--config", str(cfg), "--reso", "[[12,12,12]]", "--thresh_type",
            "sigma", "--device", "cpu"]
    args = tcfg.maybe_merge_config_file(tcli.build_parser().parse_args(argv))
    want = vars(jcfg.maybe_merge_config_file(jcli.build_parser().parse_args(argv[:-2])))
    got = dict(vars(args))
    assert got.pop("device") == "cpu" and got == want and args.n_iters == 3
    grid, _, _ = tcli.run(args, scene=scene, test_scene=scene)
    assert grid.reso == (12, 12, 12)
    cfg.write_text(json.dumps({"no_such_key": 1}))
    with pytest.raises(ValueError, match="invalid config keys"):
        tcfg.maybe_merge_config_file(tcli.build_parser().parse_args(argv))


def test_logger_and_memory_tracker_keys_match_jax(tmp_path):
    stats = {"mse": torch.tensor(0.25), "psnr": np.float32(6.0), "n": 3}
    for mod, d, s in ((tlog, tmp_path / "t", stats), (jlog, tmp_path / "j", {**stats, "mse": jnp.float32(0.25)})):
        log = mod.MetricsLogger(str(d))
        log.log_training_step(5, s, 0.1, timing_info={"step_ms": 1.0}, memory_metrics={"device_memory_gb": 0.0})
        log.log_evaluation_step(6, {"psnr": 20.0})
        log.log_octree_evaluation(7, {"psnr": 19.0}, {"n": 1})
    t, j = (json.load(open(tmp_path / x / "metrics_log.json")) for x in ("t", "j"))
    for a, b in zip(t, j):
        a.pop("timestamp"), b.pop("timestamp")
        assert a == b
    tt, jt = tmem.MemoryTracker(), jmem.MemoryTracker()
    assert set(tt.get_memory_metrics(tt.capture_snapshot(1))) == set(jt.get_memory_metrics(jt.capture_snapshot(1)))
    assert tt.get_memory_metrics()["process_rss_gb"] > 0
    want = jt.calculate_efficiency_indices(30.0, 0.9, 0.1, storage_size_gb=0.5, compression_ratio=4.0,
                                           occupancy_ratio=0.2)
    assert set(tt.calculate_efficiency_indices(30.0, 0.9, 0.1, storage_size_gb=0.5, compression_ratio=4.0,
                                               occupancy_ratio=0.2)) == set(want)
    assert tt.get_model_size_estimate(torch.nn.Linear(3, 4)) == {"param_count": 16, "param_gb": 64 / 1e9}


def test_advanced_metrics_match_jax():
    jg, tg = random_grids(16, 1, seed=11, dens_hi=1.0)
    for kw in ({"threshold": 0.5, "min_object_size": 10}, {"threshold": 0.9, "use_adaptive": False}):
        assert tam.compute_fdr(tg, **kw) == jam.compute_fdr(jg, **kw)
    assert tam.compute_mcq(25.0, 2048.0) == jam.compute_mcq(25.0, 2048.0)
    assert tam.compute_smei(25.0, 10**8) == jam.compute_smei(25.0, 10**8)
    got = tam.compute_all_advanced_metrics(tg, 25.0, 2048.0, storage_bytes=10**8, fdr_kwargs={"threshold": 0.5})
    assert got == jam.compute_all_advanced_metrics(jg, 25.0, 2048.0, storage_bytes=10**8,
                                                   fdr_kwargs={"threshold": 0.5})


def test_timing_tb_and_yaml_helpers(tmp_path, capsys):
    with Timing("block") as t:
        torch.ones(4).sum()
    assert t.elapsed_ms >= 0 and "block:" in capsys.readouterr().out
    with profiler_trace(None):
        pass
    tb = SummaryWriter(str(tmp_path / "tb"))
    tb.scalar("x", torch.tensor(1.0), 1)
    tb.image("img", torch.zeros(2, 2, 3), 1)
    tb.flush()
    tb.close()
    yaml = pytest.importorskip("yaml")
    cfg = tcfg.load_or_create_config(None)
    assert cfg == jcfg.load_or_create_config(None) and cfg.netwidth == 256
    tcfg.save_yaml({"a": 1}, str(tmp_path / "c.yaml"))
    assert tcfg.load_yaml(str(tmp_path / "c.yaml")) == {"a": 1} and yaml is not None


def test_profiler_trace_writes_the_programs_spans(tmp_path):
    """--profile_dir: beside the profiler's files, the program's spans and
    counters recorded over the same block, summed by name."""
    from nerf_projects_tpu_torch.obs import trace

    with profiler_trace(str(tmp_path / "prof")):
        with trace.span("plenoxels.step"):
            with trace.span("plenoxels.sweep"):
                torch.ones(8).sum()
            trace.count("plenoxels.rows_swept", 9)
    assert not trace.recording()
    files = set(os.listdir(tmp_path / "prof"))
    assert {"trace.json", "key_averages.txt", "spans.txt"} <= files
    text = (tmp_path / "prof" / "spans.txt").read_text()
    rows = {line.split()[0]: line.split()[1:] for line in text.splitlines() if line.strip()}
    assert rows["plenoxels.step"][0] == "1" and rows["plenoxels.sweep"][0] == "1"
    assert rows["plenoxels.rows_swept"] == ["9"]


def test_run_refuses_the_host_and_floater_viz(tmp_path, scene, monkeypatch):
    """--log_floater_viz logs what JAX's CLI logs of the final grid (JAX's
    log_floater_visualizations on the saved checkpoint, its cameras built
    by JAX's pose conversion); without --device cpu and no card, run
    refuses the host."""
    import nerf_projects_tpu_torch.obs.tb as ttb
    from nerf_projects_tpu.obs.floater_viz import log_floater_visualizations
    from tests.test_torch_video_floaters import Recorder, assert_same_log

    recorders = []
    monkeypatch.setattr(ttb, "SummaryWriter", lambda *a, **k: recorders.append(Recorder()) or recorders[-1])
    args = cli_args(tmp_path, "--log_floater_viz", "--fdr_density_threshold", "0.5")
    tcli.run(args, scene=scene, test_scene=scene)
    got = [c for c in recorders[0].calls if c[1].startswith("floaters/")]
    want = Recorder()
    cams = [(jcli._to_opencv_pose(scene.poses[v], scene), np.asarray(scene.intrinsics), scene.height, scene.width)
            for v in range(2)]
    log_floater_visualizations(want, JaxSparseGrid.load(str(tmp_path / "ckpt" / "ckpt.npz")), 4, cameras=cams,
                               gt_images=[scene.images[v] for v in range(2)], threshold=0.5,
                               n_slices=args.floater_viz_slices)
    assert len(got) >= 4 and got[0][1] == "floaters/voxels"
    assert_same_log(got, want.calls)
    if not torch.cuda.is_available():
        args = tcli.build_parser().parse_args(["--train_dir", str(tmp_path / "c3")])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.run(args, scene=scene, test_scene=scene)
