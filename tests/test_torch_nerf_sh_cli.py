"""The port's NeRF-SH CLIs (``cli/train_nerf_sh.py::train_main`` and
``main``, ``cli/eval_nerf_sh.py::evaluate`` and ``main``) against the JAX
package (CPU), at a small size: depth 2, width 32, 8 + 8 samples, 24^2
images, <= 15 steps. The JAX runs are shared through a module fixture."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.cli import eval_nerf_sh as jeval
from nerf_projects_tpu.cli import nerf_sh_flags as jflags
from nerf_projects_tpu.cli import train_nerf_sh as jtrain
from nerf_projects_tpu.data.base import SceneData as JSceneData
from nerf_projects_tpu.obs import metrics as jmetrics
from nerf_projects_tpu.train.nerf_sh_trainer import NeRFSHTrainer as JSHTrainer
from nerf_projects_tpu_torch.cli import eval_nerf_sh as teval
from nerf_projects_tpu_torch.cli import train_nerf_sh as ttrain
from nerf_projects_tpu_torch.cli.nerf_sh_flags import NeRFSHFlags, build_model
from nerf_projects_tpu_torch.data.base import SceneData
from nerf_projects_tpu_torch.data.synthetic import make_dataset
from nerf_projects_tpu_torch.models.nerf_sh import nerf_sh_flax_to_state_dict
from nerf_projects_tpu_torch.train import NeRFSHTrainer
from tests.test_torch_fused_mlp import random_biases

SMALL = dict(sh_deg=1, use_viewdirs=False, num_coarse_samples=8, num_fine_samples=8, net_depth=2, net_width=32,
             max_deg_point=4, batch_size=64, print_every=5, save_every=10, render_every=10, chunk=256)
STEPS = 10
EVAL_FILES = ("nerf_evaluation_steps.json", "nerf_evaluation_summary.json", "nerf_evaluation_final.json")
MSE_RTOL = 1e-4   # float32 modules on both sides, sums in another order
PSNR_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one thread each, so that parallel test workers
    do not oversubscribe the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def jax_in_one_program():
    """JAX's init_state, its CLI's rays and its SSIM through jitted copies
    of the same functions (init_state gives the same parameters): eager,
    each of their ops compiles on its own, ~12 s for init_state on a CPU."""
    init = jax.jit(JSHTrainer.init_state, static_argnums=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSHTrainer, "init_state", lambda self, key: init(self, key))
        mp.setattr(jtrain, "camera_rays", jax.jit(jtrain.camera_rays, static_argnums=(0, 1),
                                                  static_argnames=("pixel_center",)))
        mp.setattr(jmetrics, "compute_ssim", jax.jit(jmetrics.compute_ssim, static_argnames=(
            "max_val", "filter_size", "filter_sigma", "k1", "k2", "return_map")))
        yield


def scene_pair():
    ds = make_dataset(n_views=3, image_size=24, device="cpu")
    arrays = dict(images=ds["images"].numpy(), poses=ds["poses"], intrinsics=ds["intrinsics"], near=ds["near"],
                  far=ds["far"])
    return SceneData(**arrays), JSceneData(**arrays)


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def metric_shape(entries):
    """A MetricsLogger file's entries as (step, phase, metric keys,
    additional_info keys and their keys)."""
    return [(e["step"], e["phase"], sorted(e["metrics"]),
             {k: sorted(v) for k, v in e.get("additional_info", {}).items()}) for e in entries]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """train_main on both sides for STEPS steps, then a port resume to 15;
    evaluate on both sides from the trained state; evaluate on both sides
    of JAX's init weights (random biases) carried across, passed in and,
    on the port, read back from checkpoint.pt through flags.json."""
    scene, jscene = scene_pair()
    out = {"scene": scene, "jscene": jscene}
    jdir, tdir = (str(tmp_path_factory.mktemp(s)) for s in ("jax", "port"))
    jf = jflags.NeRFSHFlags(train_dir=jdir, **SMALL)
    tf = NeRFSHFlags(train_dir=tdir, **SMALL)
    out["jax_train"] = jtrain.train_main(jf, scene=jscene, test_scene=jscene, max_steps=STEPS)
    out["port_train"] = ttrain.train_main(tf, scene=scene, test_scene=scene, max_steps=STEPS, device="cpu")
    out["jax_log"] = read_json(jdir, "metrics_log.json")
    out["port_log"] = read_json(tdir, "metrics_log.json")
    out["jax_files"], out["port_files"] = set(os.listdir(jdir)), set(os.listdir(tdir))
    out["jax_flags_json"], out["port_flags_json"] = read_json(jdir, "flags.json"), read_json(tdir, "flags.json")
    trainer, state = out["port_train"][:2]
    out["restored"] = ttrain.load_checkpoint(os.path.join(tdir, "checkpoint.pt"), trainer.init_state(0))
    jt, js = out["jax_train"][:2]
    out["jax_eval"] = jeval.evaluate(jf, trainer=jt, state=js, scene=jscene)
    out["port_eval"] = teval.evaluate(tf, trainer=trainer, state=state, scene=scene)
    out["jax_eval_json"] = [read_json(jdir, f) for f in EVAL_FILES]
    out["port_eval_json"] = [read_json(tdir, f) for f in EVAL_FILES]
    out["resumed"] = ttrain.train_main(NeRFSHFlags(train_dir=tdir, **SMALL), scene=scene, test_scene=scene,
                                       max_steps=15, device="cpu")[1]
    with open(os.path.join(tdir, "timings.txt")) as f:
        out["timings"] = [int(line.split()[0]) for line in f]

    # JAX's init weights with random biases on both sides; JAX's trained
    # trainer renders them (render_eval is deterministic), so its jitted
    # render compiles once
    init = jt.init_state(jax.random.PRNGKey(0))
    params = random_biases(jax.tree_util.tree_map(np.asarray, init.params), 3)
    jtrainer, jstate = jt, init._replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    cdir = str(tmp_path_factory.mktemp("carried"))
    flags = NeRFSHFlags(train_dir=cdir, **SMALL)
    ptrainer = NeRFSHTrainer(build_model(flags), randomized=False, device="cpu")
    pstate = ptrainer.init_state(0)
    pstate.model.load_state_dict(nerf_sh_flax_to_state_dict(params), strict=True)
    jcdir = str(tmp_path_factory.mktemp("jax_carried"))
    out["jax_carried"] = jeval.evaluate(jflags.NeRFSHFlags(train_dir=jcdir, **SMALL), trainer=jtrainer, state=jstate,
                                        scene=jscene)
    out["jax_carried_steps"] = read_json(jcdir, EVAL_FILES[0])
    out["port_carried"] = teval.evaluate(flags, trainer=ptrainer, state=pstate, scene=scene)
    out["port_carried_steps"] = read_json(cdir, EVAL_FILES[0])
    # read back: checkpoint.pt and flags.json, then a fresh evaluate from
    # flags that know only the directories (every second view)
    with open(os.path.join(cdir, "flags.json"), "w") as f:
        json.dump(dataclasses.asdict(flags), f)
    ttrain.save_checkpoint(os.path.join(cdir, "checkpoint.pt"), pstate)
    out["reloaded"] = teval.evaluate(NeRFSHFlags(train_dir=cdir, approx_eval_skip=2, save_output=False), scene=scene,
                                     device="cpu")
    out["reloaded_steps"] = read_json(cdir, EVAL_FILES[0])
    return out


def test_train_main_writes_jax_files_and_keys(runs):
    assert runs["port_files"] == {f.replace(".msgpack", ".pt") for f in runs["jax_files"]}
    assert {"checkpoint.pt", "flags.json", "timings.txt", "metrics_log.json"} <= runs["port_files"]
    assert metric_shape(runs["port_log"]) == metric_shape(runs["jax_log"])
    assert [e["phase"] for e in runs["port_log"]] == ["training", "training", "evaluation"]
    trainer, state, scene, test_scene = runs["port_train"]
    assert state.step == STEPS and scene is test_scene is runs["scene"]


def test_flags_json_is_the_flags_as_jax_writes_them(runs):
    jf, pf = runs["jax_flags_json"], runs["port_flags_json"]
    assert list(pf) == [f.name for f in dataclasses.fields(NeRFSHFlags)]
    assert set(pf) - set(jf) == {"use_fused_trunk"} and not pf["use_fused_trunk"]
    assert {k: pf[k] for k in jf if k != "train_dir"} == {k: v for k, v in jf.items() if k != "train_dir"}


def test_steps_per_sec_is_over_the_print_interval(runs):
    """The port's steps_per_sec is print_every over the interval; JAX's
    resets its clock first and reads print_every / 1e-9 (ROADMAP Queue 3,
    "Found in the reference")."""
    for e in (e for e in runs["port_log"] if e["phase"] == "training"):
        t = e["additional_info"]["timing"]
        assert t["steps_per_sec"] * SMALL["batch_size"] == pytest.approx(t["rays_per_sec"], rel=1e-12)
        assert t["steps_per_sec"] < 1e6
    for e in (e for e in runs["jax_log"] if e["phase"] == "training"):
        assert e["additional_info"]["timing"]["steps_per_sec"] == pytest.approx(SMALL["print_every"] / 1e-9)


def test_evaluate_writes_jax_json_keys(runs):
    for got, want in zip(runs["port_eval_json"], runs["jax_eval_json"]):
        if isinstance(want, list):
            assert [list(g) for g in got] == [list(w) for w in want]
        else:
            assert list(got) == list(want)
            for k, v in want.items():
                if isinstance(v, dict):
                    assert list(got[k]) == list(v), k
    assert runs["port_eval"]["n_images"] == runs["jax_eval"]["n_images"] == 3
    assert runs["port_eval"]["rays_per_sec"] > 0


def test_resume_restores_the_checkpoint_and_continues(runs):
    got, want = runs["restored"], runs["port_train"][1]
    assert got.step == want.step == STEPS
    for (na, pa), (nb, pb) in zip(got.model.named_parameters(), want.model.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    sa, sb = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and set(sa["state"]) == set(sb["state"])
    for k in sb["state"]:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name]), (k, name)
    assert torch.equal(got.generator.get_state(), want.generator.get_state())
    assert runs["resumed"].step == 15
    assert runs["timings"] == [5, 10, 15]


def assert_metrics_close(got, want):
    assert [list(g) for g in got] == [list(w) for w in want]
    for g, w in zip(got, want):
        assert g["image_index"] == w["image_index"]
        assert g["mse"] == pytest.approx(w["mse"], rel=MSE_RTOL)
        assert g["psnr"] == pytest.approx(w["psnr"], abs=PSNR_ATOL)
        assert g["ssim"] == pytest.approx(w["ssim"], abs=1e-4)


def test_evaluate_on_jax_weights_matches_jax(runs):
    assert_metrics_close(runs["port_carried_steps"], runs["jax_carried_steps"])
    for k in ("mse", "psnr", "ssim"):
        assert runs["port_carried"][k] == pytest.approx(runs["jax_carried"][k], rel=MSE_RTOL, abs=PSNR_ATOL)


def test_evaluate_from_checkpoint_and_flags_json(runs):
    """A fresh evaluate restores the architecture from flags.json and the
    weights from checkpoint.pt: JAX's metrics on views 0 and 2."""
    assert runs["reloaded"]["n_images"] == 2
    assert_metrics_close(runs["reloaded_steps"], runs["jax_carried_steps"][::2])


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_main_parses_flags_as_jax(cli, monkeypatch):
    argv = ["--train_dir", "/x/run", "--sh_deg", "2", "--use_viewdirs", "False", "--lr_init", "0.001",
            "--batch_size", "512", "--noise_std", "0.5", "--white_bkgd", "1", "--model", "nerf_sh"]
    seen = {}
    if cli == "train":
        monkeypatch.setattr(jtrain, "train_main", lambda flags, max_steps=None: seen.update(jax=(flags, max_steps)))
        monkeypatch.setattr(ttrain, "train_main", lambda flags, max_steps=None, device=None:
                            seen.update(port=(flags, max_steps, device)))
        jtrain.main(argv + ["--smoke_steps", "7"])
        ttrain.main(argv + ["--smoke_steps", "7", "--device", "cpu"])
        assert seen["jax"][1] == seen["port"][1] == 7
    else:
        summary = {"psnr": 1.0, "memory": {}}
        monkeypatch.setattr(jeval, "evaluate", lambda flags: seen.update(jax=(flags,)) or summary)
        monkeypatch.setattr(teval, "evaluate", lambda flags, device=None: seen.update(port=(flags, None, device))
                            or summary)
        jeval.main(argv)
        teval.main(argv + ["--device", "cpu"])
    assert seen["port"][2] == "cpu"
    got, want = dataclasses.asdict(seen["port"][0]), dataclasses.asdict(seen["jax"][0])
    assert got.pop("use_fused_trunk") is False
    assert got == want
    # a flag whose default is None parses as a string, on both sides
    assert (got["sh_deg"], got["use_viewdirs"], got["lr_init"], got["noise_std"]) == (2, False, 1e-3, "0.5")


def test_train_main_device_none_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    scene, _ = scene_pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train_main(NeRFSHFlags(train_dir=str(tmp_path), **SMALL), scene=scene, max_steps=1)
