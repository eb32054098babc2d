"""The port's vanilla-NeRF training loop (``train/loop.py``), its CLI
(``cli/train_nerf.py``) and the Keras weight import (``utils/interop.py``)
against the JAX package (CPU), at a small size: depth 2, width 32, 8 + 8
samples, 24^2 images, <= 10 steps.

The JAX runs are shared through module-scoped fixtures. Both sides start
from JAX's init weights (random biases) carried across; with perturb 0
and noise 0 a step is deterministic, and the port's draw is patched to
the indices the test also hands JAX's ``train_step``.
"""
import csv
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.cli import train_nerf as jcli
from nerf_projects_tpu.data.base import SceneData as JSceneData
from nerf_projects_tpu.models.nerf import NeRFMLP as FlaxNeRFMLP
from nerf_projects_tpu.models.pipeline import NeRFRenderConfig as JConfig
from nerf_projects_tpu.obs import metrics as jmetrics
from nerf_projects_tpu.train import loop as jloop
from nerf_projects_tpu.train.nerf_trainer import NeRFTrainer as JTrainer
from nerf_projects_tpu.utils import interop as jinterop
from nerf_projects_tpu.utils.config import AttrDict as JAttrDict
from nerf_projects_tpu_torch.cli import train_nerf as tcli
from nerf_projects_tpu_torch.core.rays import pose_spherical
from nerf_projects_tpu_torch.data.base import SceneData
from nerf_projects_tpu_torch.models.nerf import NeRFMLP, flax_to_state_dict
from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig
from nerf_projects_tpu_torch.ops.posenc import posenc_dim
from nerf_projects_tpu_torch.train import loop
from nerf_projects_tpu_torch.train.nerf_trainer import NeRFTrainer
from nerf_projects_tpu_torch.utils import interop
from nerf_projects_tpu_torch.utils.config import AttrDict, create_default_config
from tests.test_loop import _make_blender_set
from tests.test_torch_fused_mlp import random_biases

SIZE = 24
STEPS = 8
SMALL = dict(N_rand=64, N_samples=8, N_importance=8, netdepth=2, netwidth=32, multires=4, multires_views=2,
             use_viewdirs=True, perturb=0.0, raw_noise_std=0.0, lrate=5e-3, lrate_decay=1, testskip=1)
CHUNK = 1024  # rays a render chunk: a view in one, where the trainers' default 16,384 pads it 28-fold
# the port and JAX render with float32 modules on both sides: sums in another order
MSE_RTOL = 1e-4
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
def quicker_renders():
    """Both trainers render in chunks of CHUNK rays, run_testset_eval
    included (it takes render_image's default): the same rays, with a
    28th of the padding. JAX's loop makes its rays and SSIM through jitted
    copies of the same functions: eager, each of their ops compiles on its
    own at every new image size, a few seconds a size on a CPU."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JTrainer, NeRFTrainer):
            mp.setattr(cls, "render_image", functools.partialmethod(cls.render_image, chunk=CHUNK))
        mp.setattr(jloop, "camera_rays", jax.jit(jloop.camera_rays, static_argnums=(0, 1),
                                                 static_argnames=("pixel_center",)))
        mp.setattr(jloop, "ndc_rays", jax.jit(jloop.ndc_rays, static_argnums=(0, 1, 2, 3)))
        mp.setattr(jmetrics, "compute_ssim", jax.jit(jmetrics.compute_ssim, static_argnames=(
            "max_val", "filter_size", "filter_sigma", "k1", "k2", "return_map")))
        yield


def config(side, **kw):
    cfg = create_default_config()
    cfg.update(SMALL)
    cfg.update(kw)
    return (JAttrDict if side == "jax" else AttrDict)(cfg)


def scenes(kind: str):
    """(port SceneData, JAX SceneData) of the same arrays: a Blender-like
    capture around the origin, or a forward-facing NDC one."""
    rng = np.random.default_rng(5 if kind == "ndc" else 4)
    if kind == "ndc":
        H, W, focal = SIZE, 32, 30.0
        poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
        poses[:, :3, 3] = rng.uniform(-0.2, 0.2, (3, 3))
        kw = dict(near=0.0, far=1.0, ndc=True)
    else:
        H, W, focal = SIZE, SIZE, 28.0
        poses = np.stack([pose_spherical(t, -30.0, 4.0) for t in (0.0, 120.0, 240.0)])
        kw = dict(near=2.0, far=6.0, white_bkgd=True)
    images = rng.uniform(size=(3, H, W, 3)).astype(np.float32)
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)
    return (SceneData(images=images, poses=poses, intrinsics=K, **kw),
            JSceneData(images=images, poses=poses, intrinsics=K, **kw))


def jax_trainer(cfg, scene):
    """The JAX loop's trainer for ``cfg``, as ``train`` builds it."""
    rc = JConfig(num_coarse_samples=cfg.N_samples, num_fine_samples=cfg.N_importance, multires=cfg.multires,
                 multires_views=cfg.multires_views, use_viewdirs=cfg.use_viewdirs, lindisp=cfg.lindisp,
                 perturb=cfg.perturb > 0, raw_noise_std=cfg.raw_noise_std, white_bkgd=cfg.white_bkgd)
    return JTrainer(rc, depth=cfg.netdepth, width=cfg.netwidth, lrate=cfg.lrate, lrate_decay=cfg.lrate_decay,
                    near=scene.near, far=scene.far)


def jax_init(trainer):
    """JAX's init state (PRNGKey(0), as the loop) with random biases."""
    state = trainer.init_state(jax.random.PRNGKey(0))
    params = tuple(random_biases(jax.tree_util.tree_map(np.asarray, p), 10 + i)
                   for i, p in enumerate(state.params))
    return state._replace(params=jax.tree_util.tree_map(jnp.asarray, params)), params


def port_trainer(cfg, scene):
    rc = NeRFRenderConfig(num_coarse_samples=cfg.N_samples, num_fine_samples=cfg.N_importance,
                          multires=cfg.multires, multires_views=cfg.multires_views, use_viewdirs=cfg.use_viewdirs,
                          lindisp=cfg.lindisp, perturb=cfg.perturb > 0, raw_noise_std=cfg.raw_noise_std,
                          white_bkgd=cfg.white_bkgd)
    return NeRFTrainer(rc, depth=cfg.netdepth, width=cfg.netwidth, lrate=cfg.lrate, lrate_decay=cfg.lrate_decay,
                       near=scene.near, far=scene.far, device="cpu")


def carried_state(trainer, params):
    """The port's init state holding JAX's weights."""
    state = trainer.init_state(0)
    for model, tree in zip(state.params, params):
        model.load_state_dict(flax_to_state_dict(tree), strict=True)
    return state


# ---------------------------------------------------------------------------
# The Keras import
# ---------------------------------------------------------------------------

def test_keras_import_matches_jax():
    """A TF-NeRF Keras weight list (the flax layout's kernels and biases in
    nerf.py:113-146's order) through each side's import: the same numpy
    tree, and the port's NeRFMLP on it gives JAX's NeRFMLP outputs."""
    rng = np.random.default_rng(0)
    cp, cv = posenc_dim(3, 10), posenc_dim(3, 4)
    tree = jax.jit(FlaxNeRFMLP(depth=8, width=32, use_viewdirs=True).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, cp)), jnp.zeros((1, cv)))["params"]
    order = [f"trunk_{i}" for i in range(8)] + ["bottleneck", "view_0", "rgb_head", "sigma_head"]
    weights = [rng.normal(0, 0.3, np.shape(tree[n][k])).astype(np.float32) for n in order for k in ("kernel", "bias")]
    want = jinterop.nerf_params_from_keras(weights, depth=8)
    got = interop.nerf_params_from_keras(weights, depth=8)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    x = rng.normal(size=(257, cp)).astype(np.float32)
    v = rng.normal(size=(257, cv)).astype(np.float32)
    ref = jax.jit(FlaxNeRFMLP(depth=8, width=32, use_viewdirs=True).apply)(want, jnp.asarray(x), jnp.asarray(v))
    model = NeRFMLP(depth=8, width=32, use_viewdirs=True, in_ch=cp, in_ch_views=cv)
    model.load_state_dict(flax_to_state_dict(got), strict=True)
    out = model(torch.from_numpy(x), torch.from_numpy(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert interop.nerf_sh_params_from_jaxnerf is not None
    src = {"params": {"MLP_0": {"Dense_0": {"kernel": weights[0], "bias": weights[1]}}, "sg_lambda": weights[3]}}
    jax.tree_util.tree_map(np.testing.assert_array_equal, interop.nerf_sh_params_from_jaxnerf(src),
                           jinterop.nerf_sh_params_from_jaxnerf(src))


# ---------------------------------------------------------------------------
# Ray pools, per-view rays, crop ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["blender", "ndc"])
def test_pools_and_crop_ids_match_jax(kind):
    scene, jscene = scenes(kind)
    rays, rgb = loop._build_ray_pool(scene, "cpu")
    jrays, jrgb = jloop._build_ray_pool(jscene)
    vrays, vrgb = loop._per_view_rays(scene, "cpu")
    jvrays, jvrgb = jloop._per_view_rays(jscene)
    for got, want in ((rays, jrays), (vrays, jvrays)):
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    np.testing.assert_array_equal(vrgb.numpy(), np.asarray(jvrgb))
    for frac in (0.5, 0.25, 1.0):
        ids = loop._precrop_pixel_ids(scene.height, scene.width, frac, "cpu")
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jloop._precrop_pixel_ids(scene.height, scene.width,
                                                                                       frac)))


# ---------------------------------------------------------------------------
# run_testset_eval on JAX's weights carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    """Per scene kind: both sides' trainers and states on JAX's weights,
    shared so that JAX's jitted render compiles once a kind."""
    out = {}
    for kind in ("blender", "ndc"):
        scene, jscene = scenes(kind)
        jtrainer = jax_trainer(config("jax", white_bkgd=scene.white_bkgd), jscene)
        jstate, params = jax_init(jtrainer)
        trainer = port_trainer(config("port", white_bkgd=scene.white_bkgd), scene)
        out[kind] = (scene, jscene, jtrainer, jstate, trainer, carried_state(trainer, params))
    return out


@pytest.mark.parametrize("kind,render_factor", [("blender", 0), ("ndc", 0), ("blender", 2)])
def test_testset_eval_matches_jax(kind, render_factor, carried, tmp_path):
    scene, jscene, jtrainer, jstate, trainer, state = carried[kind]
    cfg = config("port", render_factor=render_factor, white_bkgd=scene.white_bkgd)
    jcfg = config("jax", render_factor=render_factor, white_bkgd=scene.white_bkgd)
    want_mean = jloop.run_testset_eval(jcfg, jtrainer, jstate, jscene, str(tmp_path / "jax"), 7)
    got_mean = loop.run_testset_eval(cfg, trainer, state, scene, str(tmp_path / "port"), 7)
    with open(tmp_path / "jax" / "testset_000007" / "metrics.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "testset_000007" / "metrics.json") as f:
        got = json.load(f)
    assert list(got) == list(want) == ["per_image", "mean", "step"] and got["step"] == 7
    assert list(got_mean) == list(want_mean) == list(got["mean"])
    assert len(got["per_image"]) == len(want["per_image"]) == 3
    for g, w in zip(got["per_image"] + [got_mean], want["per_image"] + [want_mean]):
        assert list(g) == list(w)
        assert g["mse"] == pytest.approx(w["mse"], rel=MSE_RTOL)
        assert g["psnr"] == pytest.approx(w["psnr"], abs=PSNR_ATOL)
        assert g["ssim"] == pytest.approx(w["ssim"], abs=1e-4)
    pngs = sorted(p for p in os.listdir(tmp_path / "port" / "testset_000007") if p.endswith(".png"))
    assert pngs == sorted(p for p in os.listdir(tmp_path / "jax" / "testset_000007") if p.endswith(".png"))


# ---------------------------------------------------------------------------
# Loop steps against JAX's train_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """STEPS loop steps on the Blender-like scene from JAX's init weights on
    both sides, the port's draws patched to the indices fed to JAX."""
    scene, jscene = scenes("blender")
    base = tmp_path_factory.mktemp("steps")
    cfg = config("port", basedir=str(base), expname="port", white_bkgd=True, i_print=1, i_weights=1000,
                 i_testset=1000)
    jcfg = config("jax", white_bkgd=True)
    jtrainer = jax_trainer(jcfg, jscene)
    jstate, params = jax_init(jtrainer)
    n_pool = 3 * SIZE * SIZE
    rng = np.random.default_rng(3)
    ids = [rng.integers(0, n_pool, cfg.N_rand) for _ in range(STEPS)]

    pool, pool_rgb = jloop._build_ray_pool(jscene)
    value_and_grad = jax.jit(jtrainer._value_and_grad)
    jlosses, jgrads = [], []
    for idx in ids:
        rays, target = jax.tree_util.tree_map(lambda x: x[idx], pool), pool_rgb[idx]
        (_, _), g = value_and_grad(jstate.params, jstate.key, rays, target)
        jgrads.append(jax.tree_util.tree_map(np.asarray, g))
        jstate, stats = jtrainer.train_step(jstate, rays, target)
        jlosses.append(float(stats["loss"]))

    # the port starts from a step-0 checkpoint holding JAX's weights
    trainer = port_trainer(cfg, scene)
    start = carried_state(trainer, params)
    loop.save_checkpoint(os.path.join(base, "port", "checkpoints", f"{0:09d}.pt"), start)
    draws = list(ids)

    def draw_ids(generator, high, n):
        assert (high, n) == (n_pool, cfg.N_rand)
        return torch.from_numpy(draws.pop(0))

    old = loop._draw_ids
    loop._draw_ids = draw_ids
    try:
        _, state = loop.train(cfg, max_iters=STEPS, scene=scene, device="cpu")
    finally:
        loop._draw_ids = old
    with open(os.path.join(base, "port", "training_log.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    return dict(state=state, losses=losses, jlosses=jlosses, jstate=jstate, jgrads=jgrads, init=params,
                lr=[float(jtrainer.schedule(k)) for k in range(STEPS)])


def test_loop_losses_match_jax_steps(stepped):
    assert len(stepped["losses"]) == STEPS and stepped["state"].step == STEPS
    np.testing.assert_allclose(stepped["losses"], stepped["jlosses"], rtol=1e-5)
    assert stepped["losses"][-1] < stepped["losses"][0]


def test_loop_updates_match_jax_steps(stepped):
    """The parameters after STEPS steps, compared as updates (ROADMAP,
    "Limits of comparison"): where JAX's gradient stays above 1e-3 of its
    tensor's largest entry on every step, far above Adam's eps, Adam's
    update is a smooth function of the gradients and the port's total
    update is JAX's within 1e-4 of the summed learning rates; elsewhere
    within 1e-3 of them; every parameter that JAX moved, the port moved."""
    state, jstate = stepped["state"], stepped["jstate"]
    lr_sum = sum(stepped["lr"])
    n_held = 0
    for level in (0, 1):
        init = flax_to_state_dict(stepped["init"][level])
        want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params[level]))
        grads = [flax_to_state_dict(g[level]) for g in stepped["jgrads"]]
        for name, p in state.params[level].named_parameters():
            up = p.detach().numpy().astype(np.float64) - init[name].numpy()
            uj = want[name].numpy().astype(np.float64) - init[name].numpy()
            gs = np.stack([g[name].numpy() for g in grads])
            scale = np.abs(gs).max()
            clear = (np.abs(gs) > 1e-3 * np.abs(gs).max()).all(0)
            err = np.abs(up - uj)
            assert (err[clear] <= 1e-4 * lr_sum).all(), (level, name, float(err[clear].max() / lr_sum))
            assert (err <= 1e-3 * lr_sum).all(), (level, name, float(err.max() / lr_sum))
            assert ((up != 0) | (uj == 0)).all(), (level, name)
            n_held += int(clear.sum())
    assert n_held > 4000, n_held


# ---------------------------------------------------------------------------
# train() end to end, resumed, and without batching
# ---------------------------------------------------------------------------

E2E = dict(N_rand=64, i_print=5, i_weights=5, i_testset=10, perturb=1.0, dataset_type="blender",
           white_bkgd=True, half_res=False, expname="e2e")


def tree_of(exp):
    """Each file's path under ``exp``, checkpoints by their step, the tb
    event files by their directory."""
    out = set()
    for d, _, files in os.walk(exp):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), exp)
            out.add("tb/*" if rel.startswith("tb" + os.sep) else os.path.splitext(rel)[0]
                    if rel.startswith("checkpoints") else rel)
    return out


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """train() on a Blender root on disk, 10 steps each: batching, then the
    same run resumed to 15, then no_batching with a 5-step precrop; JAX's
    loop on the same root and config."""
    root = str(tmp_path_factory.mktemp("scene"))
    _make_blender_set(root, n=3, size=SIZE)
    out = {}
    for side, run in (("jax", jloop.train), ("port", loop.train)):
        base = str(tmp_path_factory.mktemp(side))
        kw = dict(device="cpu") if side == "port" else {}
        cfg = config(side, datadir=root, basedir=base, **E2E)
        trainer, state = run(cfg, max_iters=10, **kw)
        exp = os.path.join(base, "e2e")
        out[side] = dict(exp=exp, tree=tree_of(exp), cfg=cfg, trainer=trainer, state=state)
        if side == "port":
            latest = loop.latest_checkpoint(os.path.join(exp, "checkpoints"))
            out["restored"] = loop.load_checkpoint(latest, trainer.init_state(0))
            with open(os.path.join(exp, "training_log.jsonl")) as f:
                out["log_10"] = [json.loads(line) for line in f]
            _, out["resumed"] = run(cfg, max_iters=15, **kw)
            with open(os.path.join(exp, "training_log.jsonl")) as f:
                out["log_15"] = [json.loads(line) for line in f]
            calls, draw = [], loop._draw_ids

            def draw_ids(generator, high, n):
                calls.append((high, n))
                return draw(generator, high, n)

            loop._draw_ids = draw_ids
            try:
                nb = config(side, datadir=root, basedir=base, **{**E2E, "expname": "nobatch"}, no_batching=True,
                            precrop_iters=5, precrop_frac=0.5)
                _, out["nobatch"] = run(nb, max_iters=10, **kw)
            finally:
                loop._draw_ids = draw
            out["nobatch_calls"] = calls
    return out


def test_train_writes_jax_files_and_keys(e2e):
    j, p = e2e["jax"], e2e["port"]
    assert p["tree"] == j["tree"], p["tree"] ^ j["tree"]
    assert {"checkpoints/000000005", "checkpoints/000000010", "testset_000010/metrics.json",
            "training_log.jsonl", "training_log.csv", "metrics_log.json"} <= p["tree"]
    logs = {}
    for side in ("jax", "port"):
        exp = e2e[side]["exp"]
        with open(os.path.join(exp, "metrics_log.json")) as f:
            entries = json.load(f)
        with open(os.path.join(exp, "training_log.csv")) as f:
            header = next(csv.reader(f))
        with open(os.path.join(exp, "testset_000010", "metrics.json")) as f:
            metrics = json.load(f)
        logs[side] = dict(
            header=header,
            jsonl=[list(e) for e in e2e["log_10"]] if side == "port" else None,
            entries=[(e["step"], e["phase"], list(e["metrics"]), sorted(e.get("additional_info", {})))
                     for e in entries if e["step"] <= 10],  # the port's run was then resumed to 15
            memory=sorted(entries[0]["additional_info"]["memory"]),
            metrics=(list(metrics), list(metrics["mean"]), [list(m) for m in metrics["per_image"]]),
        )
    assert logs["port"]["header"] == logs["jax"]["header"]
    assert logs["port"]["jsonl"] == [logs["jax"]["header"]] * 2
    for key in ("entries", "memory", "metrics"):
        assert logs["port"][key] == logs["jax"][key], key
    assert e2e["port"]["state"].step == 10


def test_resume_restores_everything_and_continues(e2e):
    """The step-10 checkpoint restores the models, Adam's moments and step
    counts and the state's generator to the bit; a run to 15 resumes at 10
    and appends to the logs."""
    got, want = e2e["restored"], e2e["port"]["state"]
    assert got.step == want.step == 10
    for a, b in zip(got.params, want.params):
        for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
            assert na == nb and torch.equal(pa, pb), na
    sa, sb = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert set(sa["state"]) == set(sb["state"])
    for k in sb["state"]:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name]), (k, name)
        assert sa["state"][k]["step"].device.type == "cpu"
    assert torch.equal(got.generator.get_state(), want.generator.get_state())
    assert e2e["resumed"].step == 15
    assert [e["step"] for e in e2e["log_15"]] == [5, 10, 15]
    assert e2e["log_15"][:2] == e2e["log_10"]


def test_no_batching_draws_the_crop_then_the_whole_view(e2e):
    calls = e2e["nobatch_calls"]
    n_crop = (SIZE // 2) ** 2  # precrop_frac 0.5 of a 24^2 view
    assert e2e["nobatch"].step == 10
    assert calls == [(3, 1), (n_crop, 64)] * 5 + [(3, 1), (SIZE * SIZE, 64)] * 5


# ---------------------------------------------------------------------------
# The CLI and the device
# ---------------------------------------------------------------------------

def test_cli_override_casting_matches_jax(monkeypatch, tmp_path):
    cfg_path = tmp_path / "exp.yaml"
    cfg_path.write_text("expname: fern_test\ndataset_type: llff\nN_samples: 96\nuse_viewdirs: true\n")
    argv = ["--config", str(cfg_path), "--max_iters", "3", "--N_rand", "7", "--use_viewdirs", "FALSE",
            "--no_batching", "yes", "--lrate", "1e-3", "--raw_noise_std", "1", "--expname", "cli",
            "--ft_path", "w.npy", "--not_a_key", "4", "--precrop_frac", "0.25", "--white_bkgd", "0"]
    seen = {}
    monkeypatch.setattr(jcli, "train", lambda cfg, max_iters=None: seen.update(jax=(dict(cfg), max_iters)))
    monkeypatch.setattr(tcli, "train", lambda cfg, max_iters=None, device=None:
                        seen.update(port=(dict(cfg), max_iters, device)))
    jcli.main(argv)
    tcli.main(argv + ["--device", "cpu"])
    (got, iters, device), (want, jiters) = seen["port"], seen["jax"]
    assert (iters, device) == (jiters, "cpu") == (3, "cpu")
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}
    assert (got["N_rand"], got["use_viewdirs"], got["no_batching"], got["lrate"], got["raw_noise_std"],
            got["ft_path"], got["N_samples"]) == (7, False, True, 1e-3, 1.0, "w.npy", 96)
    assert "not_a_key" not in got


def test_train_device_none_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    scene, _ = scenes("blender")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(config("port", basedir=str(tmp_path)), max_iters=1, scene=scene)
