"""The port's training slice against the JAX package (CPU): schedules,
the synthetic scene, metrics, Adam with the schedule against optax, the
fused train-level route of NeRFTrainer against the reference's and
against the port's autograd route, and a small convergence run."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerf_projects_tpu.ops.pallas.fused_mlp as jfm
import nerf_projects_tpu.ops.pallas.fused_train as jft
from nerf_projects_tpu.core.rays import Rays as JaxRays
from nerf_projects_tpu.data import synthetic as jsyn
from nerf_projects_tpu.models.pipeline import NeRFRenderConfig as JaxConfig
from nerf_projects_tpu.obs import metrics as jmetrics
from nerf_projects_tpu.train import schedules as jsched
from nerf_projects_tpu.train.nerf_trainer import NeRFTrainer as JaxTrainer
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.data import synthetic as tsyn
from nerf_projects_tpu_torch.models.nerf import flax_to_state_dict
from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig
from nerf_projects_tpu_torch.obs import metrics as tmetrics
from nerf_projects_tpu_torch.train import NeRFTrainer, TrainState
from nerf_projects_tpu_torch.train import schedules as tsched
from tests.test_torch_fused_mlp import random_biases


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jfm.INTERPRET, jft.INTERPRET
    jfm.INTERPRET = jft.INTERPRET = True
    yield
    jfm.INTERPRET, jft.INTERPRET = old


# ---------------------------------------------------------------------------
# Schedules, data, metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["exponential", "log_linear", "log_linear_delay"])
def test_schedules_match_jax(kind):
    make = {
        "exponential": lambda m: m.exponential_decay(5e-4, 0.25),
        "log_linear": lambda m: m.log_linear_decay(5e-3, 5e-5, 1000),
        "log_linear_delay": lambda m: m.log_linear_decay(5e-3, 5e-5, 1000, lr_delay_steps=100,
                                                         lr_delay_mult=0.01),
    }[kind]
    steps = np.array([0, 1, 7, 50, 250, 999, 1000, 2000])
    want = np.asarray([float(make(jsched)(jnp.asarray(s))) for s in steps])
    got_f = np.asarray([make(tsched)(int(s)) for s in steps])
    got_t = make(tsched)(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got_f, want, rtol=1e-5)
    np.testing.assert_allclose(got_t, want, rtol=1e-5)


def test_make_dataset_matches_jax():
    """Camera poses, rays and ground-truth images of the hermetic scene."""
    want = jsyn.make_dataset(n_views=2, image_size=24)
    got = tsyn.make_dataset(n_views=2, image_size=24, device="cpu")
    np.testing.assert_allclose(got["poses"], want["poses"], rtol=0, atol=1e-6)
    for a, b in zip(got["rays"], want["rays"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    # a ray grazing a sphere's surface may see one of 256 samples flip inside/outside
    d = np.abs(got["images"].numpy() - np.asarray(want["images"]))
    assert d.shape == (2, 24, 24, 3) and np.mean(d > 1e-4) < 0.01 and d.mean() < 1e-3
    assert float(got["images"].max()) > 0.9 and float(got["images"].std()) > 0.1


def test_render_scene_and_fields_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    rgb_w, sig_w = jsyn.scene_fields(jsyn.default_scene(), jnp.asarray(pts))
    rgb_g, sig_g = tsyn.scene_fields(tsyn.default_scene(), torch.from_numpy(pts))
    np.testing.assert_array_equal(sig_g.numpy(), np.asarray(sig_w))
    inside = np.asarray(sig_w) > 0
    np.testing.assert_array_equal(rgb_g.numpy()[inside], np.asarray(rgb_w)[inside])
    d = rng.standard_normal((64, 3)).astype(np.float32)
    o = (-4.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    want = jsyn.render_scene(jsyn.default_scene(), JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d)))
    got = tsyn.render_scene(tsyn.default_scene(), Rays(*(torch.from_numpy(a) for a in (o, d, d))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_ray_and_tile_batches_shapes():
    ds = tsyn.make_dataset(n_views=2, image_size=16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    rays, target = next(tsyn.ray_batches(gen, ds, 100))
    assert tuple(rays.origins.shape) == (100, 3) and tuple(target.shape) == (100, 3)
    trays, ttarget = next(tsyn.tile_batches(gen, ds, 3, 4, 4))
    assert tuple(trays.directions.shape) == (3, 16, 3) and tuple(ttarget.shape) == (3, 16, 3)
    # a tile is a coherent patch: its targets are pixels of one view
    flat = ds["pixels"].reshape(2, 16, 16, 3)
    assert any(torch.equal(ttarget[0].reshape(4, 4, 3), flat[v, y:y + 4, x:x + 4])
               for v in range(2) for y in range(13) for x in range(13))


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(40, 36, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    want = jmetrics.compute_metrics(a, b)
    got = tmetrics.compute_metrics(torch.from_numpy(a), torch.from_numpy(b))
    assert set(got) == set(want) == {"mse", "psnr", "ssim"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    np.testing.assert_allclose(
        tmetrics.compute_ssim(a, b, return_map=True).numpy(),
        np.asarray(jmetrics.compute_ssim(a, b, return_map=True)), rtol=1e-4, atol=1e-5)
    assert float(tmetrics.mse2psnr(torch.tensor(0.01))) == pytest.approx(20.0, abs=1e-4)
    assert tmetrics.mse2psnr(0.01) == pytest.approx(20.0)
    np.testing.assert_array_equal(tmetrics.to8b(np.array([-0.5, 0.5, 2.0])), [0, 127, 255])
    assert tmetrics.compute_metrics(a, a, include_lpips=True)["lpips"] is None


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

def test_adam_with_schedule_matches_optax():
    """Three updates on the same gradients: optax evaluates the schedule
    at the count before the increment, so update k runs at schedule(k).
    lrate_decay is set so that the rate falls tenfold every step, which
    an off-by-one would show."""
    cfg = NeRFRenderConfig(num_coarse_samples=4, multires=2, multires_views=1, use_viewdirs=True)
    trainer = NeRFTrainer(cfg, depth=2, width=16, lrate=1e-2, lrate_decay=0.001, device="cpu")
    state = trainer.init_state(0)
    coarse = state.params[0]
    init = {n: p.detach().numpy().copy() for n, p in coarse.named_parameters()}
    rng = np.random.default_rng(2)
    grads = [{n: rng.standard_normal(v.shape).astype(np.float32) for n, v in init.items()} for _ in range(3)]

    schedule = jsched.exponential_decay(1e-2, 0.001)
    tx = optax.adam(learning_rate=schedule, b1=0.9, b2=0.999, eps=1e-7)
    params = {n: jnp.asarray(v) for n, v in init.items()}
    opt = tx.init(params)
    for g in grads:
        updates, opt = tx.update({n: jnp.asarray(v) for n, v in g.items()}, opt)
        params = optax.apply_updates(params, updates)
        trainer.apply_grads(state, ({n: torch.from_numpy(v) for n, v in g.items()}, None))
    assert state.step == 3
    for n, p in coarse.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), rtol=1e-5, atol=1e-7,
                                   err_msg=n)
    # the rate of the third update was schedule(2) = 1e-4, not schedule(3)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)


# ---------------------------------------------------------------------------
# The fused train-level route
# ---------------------------------------------------------------------------

def _flagship_cfgs(perturb):
    kw = dict(num_coarse_samples=8, num_fine_samples=8, multires=10, multires_views=4,
              use_viewdirs=True, white_bkgd=True, perturb=perturb)
    return JaxConfig(**kw), NeRFRenderConfig(**kw)


def _rays(n=64):
    d = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    target = np.random.default_rng(4).uniform(size=(n, 3)).astype(np.float32)
    return o, d, target


def _assert_trainer_grads_close(got, want):
    """The criteria of tests/test_fused_train.py::test_trainer_hierarchical_parity:
    all but 1% of entries within 1e-2 of the tensor's largest (all but
    one, for a tensor of fewer than 100 entries: a bias of the sigma head
    is one sum of terms that cancel), and every entry within 0.06."""
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, name
        scale = np.abs(w).max() + 1e-12
        far = ~np.isclose(g / scale, w / scale, rtol=0, atol=1e-2)
        assert far.sum() <= max(1, 0.01 * far.size), (name, int(far.sum()))
        assert np.abs(g / scale - w / scale).max() < 0.06, name


def test_mega_value_and_grad_matches_jax(monkeypatch):
    """One step of the port's fused train-level route against the
    reference's on the same parameters (seeded random biases), with
    perturb=False because the two random streams differ. The fine depths
    come from the coarse weights through the inverse CDF; there a bf16
    difference of ~1e-4 in a weight moves a fine sample, and trunk_0's
    2^9-frequency encoding turns that into a different gradient. So both
    sides are fed the same fine depths (the port's own autograd route is
    held against its fused route through the real resample below, and the
    resample itself against the reference's in test_torch_render.py)."""
    import nerf_projects_tpu.ops.sampling as jsampling
    import nerf_projects_tpu_torch.train.nerf_trainer as tnt

    jcfg, tcfg = _flagship_cfgs(perturb=False)
    jtr = JaxTrainer(jcfg, depth=8, width=256, use_fused_mlp=True, use_mega=True)
    ttr = NeRFTrainer(tcfg, depth=8, width=256, use_fused_mlp=True, use_mega=True, device="cpu")
    assert jtr.use_mega and jtr.mega_raw and ttr.use_mega
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    trees = [random_biases(jax.tree_util.tree_map(np.asarray, p), s)
             for s, p in enumerate(jstate.params)]
    params = ttr.init_params(0)
    for m, tree in zip(params, trees):
        m.load_state_dict(flax_to_state_dict(tree))
    o, d, target = _rays()
    jrays = JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d))
    trays = Rays(*(torch.from_numpy(a) for a in (o, d, d)))

    def both():
        (lj, mj), gj = jtr._mega_value_and_grad(tuple(trees), None, jrays, jnp.asarray(target))
        (lt, mt), gt = ttr._mega_value_and_grad(params, None, trays, torch.from_numpy(target))
        np.testing.assert_allclose(float(lt), float(lj), rtol=3e-3)
        np.testing.assert_allclose(float(mt), float(mj), rtol=3e-3)
        return gt, gj

    z_fine = np.sort(np.random.default_rng(6).uniform(2.0, 6.0, (len(o), 8)), axis=-1).astype(np.float32)
    monkeypatch.setattr(jsampling, "piecewise_constant_pdf", lambda *a, **k: jnp.asarray(z_fine))
    monkeypatch.setattr(tnt, "piecewise_constant_pdf", lambda *a, **k: torch.from_numpy(z_fine))
    grads_t, grads_j = both()
    for gt, gj in zip(grads_t, grads_j):
        _assert_trainer_grads_close({k: v.numpy() for k, v in gt.items()},
                                    flax_to_state_dict(jax.tree_util.tree_map(np.asarray, gj)))


def test_mega_route_matches_autograd_route():
    """The port's fused train-level route against its own autograd route
    through the fused MLP, from one generator state with perturb=True
    (both draw stratified depths, then pdf uniforms, in one order)."""
    _, tcfg = _flagship_cfgs(perturb=True)
    ttr = NeRFTrainer(tcfg, depth=8, width=256, use_fused_mlp=True, use_mega=True, device="cpu")
    gen = torch.Generator().manual_seed(5)
    params = tuple(random_biases_torch(m, gen) for m in ttr.init_params(1))
    o, d, target = _rays()
    rays, tgt = Rays(*(torch.from_numpy(a) for a in (o, d, d))), torch.from_numpy(target)
    (loss_m, mse_m), grads_m = ttr._mega_value_and_grad(params, torch.Generator().manual_seed(7), rays, tgt)
    ttr.use_mega = False
    (loss_a, mse_a), grads_a = ttr._value_and_grad(params, torch.Generator().manual_seed(7), rays, tgt)
    np.testing.assert_allclose(float(loss_m), float(loss_a), rtol=3e-3)
    np.testing.assert_allclose(float(mse_m), float(mse_a), rtol=3e-3)
    for gm, ga in zip(grads_m, grads_a):
        _assert_trainer_grads_close({k: v.numpy() for k, v in gm.items()},
                                    {k: v.numpy() for k, v in ga.items()})


def random_biases_torch(model, gen, std=0.2):
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model


def test_mega_gate_and_shared_fine_model():
    """The mega gate refuses sigma noise and other architectures; with
    no separate fine model the coarse model gets both levels' gradients."""
    _, tcfg = _flagship_cfgs(perturb=False)
    assert not NeRFTrainer(tcfg._replace(raw_noise_std=1.0), use_fused_mlp=True, use_mega=True,
                           device="cpu").use_mega
    assert not NeRFTrainer(tcfg, depth=4, use_fused_mlp=True, use_mega=True, device="cpu").use_mega
    ttr = NeRFTrainer(tcfg, use_fused_mlp=True, use_mega=True, separate_fine=False, device="cpu")
    params = ttr.init_params(0)
    assert params[1] is None
    o, d, target = _rays(16)
    rays, tgt = Rays(*(torch.from_numpy(a) for a in (o, d, d))), torch.from_numpy(target)
    _, (gc, gf) = ttr._mega_value_and_grad(params, None, rays, tgt)
    assert gf is None and set(gc) == {n for n, _ in params[0].named_parameters()}
    ttr.use_mega = False
    _, (ga, _) = ttr._value_and_grad(params, None, rays, tgt)
    _assert_trainer_grads_close({k: v.numpy() for k, v in gc.items()}, {k: v.numpy() for k, v in ga.items()})


# ---------------------------------------------------------------------------
# Training end to end
# ---------------------------------------------------------------------------

def _small_cfg(fine=0):
    return NeRFRenderConfig(num_coarse_samples=32, num_fine_samples=fine, multires=6, multires_views=2,
                            use_viewdirs=False, white_bkgd=True, perturb=True)


def test_loss_drops_and_psnr_climbs():
    """tests/test_train.py::test_loss_drops_and_psnr_climbs on the port:
    depth 4, width 96, 150 steps of 512 rays on the hermetic scene."""
    torch.manual_seed(0)
    ds = tsyn.make_dataset(n_views=4, image_size=32, device="cpu")
    trainer = NeRFTrainer(_small_cfg(), depth=4, width=96, near=ds["near"], far=ds["far"], lrate=5e-3,
                          device="cpu")
    state = trainer.init_state(0)
    batches = tsyn.ray_batches(torch.Generator().manual_seed(1), ds, 512)
    psnrs = []
    for _ in range(150):
        rays, target = next(batches)
        state, stats = trainer.train_step(state, rays, target)
        psnrs.append(float(stats["psnr"]))
    assert state.step == 150 and isinstance(state, TrainState)
    assert psnrs[-1] > psnrs[0] + 5.0, (psnrs[0], psnrs[-1])
    assert psnrs[-1] > 18.0, psnrs[-1]


def test_scan_steps_draws_from_the_pool_and_trains_hierarchically():
    ds = tsyn.make_dataset(n_views=2, image_size=16, device="cpu")
    trainer = NeRFTrainer(_small_cfg(fine=16), depth=3, width=64, near=ds["near"], far=ds["far"],
                          lrate=5e-3, device="cpu")
    state = trainer.init_state(0)
    state, stats = trainer.scan_steps(state, ds["rays"], ds["pixels"], 40, batch_size=256)
    assert state.step == 40
    assert tuple(stats["loss"].shape) == tuple(stats["psnr"].shape) == (40,)
    losses = stats["loss"].numpy()
    assert np.isfinite(losses).all() and losses[-5:].mean() < 0.6 * losses[:5].mean()
