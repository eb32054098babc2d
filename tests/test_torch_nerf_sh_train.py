"""The port's NeRF-SH trainer (``train/nerf_sh_trainer.py``) and its CLI
helpers (``cli/train_nerf_sh.py``) against the JAX package (CPU).

One train step at randomized=False, with the sparsity loss and weight
decay on and the same sparsity points on both sides (those of JAX's
``train_step`` key split): the loss and its stats, the gradients of every
parameter and the parameters after one Adam step at the scheduled rate
(JAX's optax update of its gradients), through the modules and through
the fused trunk (its plain versions here, JAX's K5 in interpret mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerf_projects_tpu.ops.pallas.fused_sh_mlp as jfsm
from nerf_projects_tpu.cli import train_nerf_sh as jcli
from nerf_projects_tpu.data.base import SceneData as JSceneData
from nerf_projects_tpu.models import nerf_sh as jsh
from nerf_projects_tpu.ops import sampling as jsampling
from nerf_projects_tpu.train.nerf_sh_trainer import NeRFSHTrainer as JTrainer
from nerf_projects_tpu_torch.cli import train_nerf_sh as tcli
from nerf_projects_tpu_torch.cli.nerf_sh_flags import NeRFSHFlags, build_model
from nerf_projects_tpu_torch.data.base import SceneData
from nerf_projects_tpu_torch.data.synthetic import make_dataset
from nerf_projects_tpu_torch.models import nerf_sh as tsh
from nerf_projects_tpu_torch.ops import sampling as tsampling
from nerf_projects_tpu_torch.train import NeRFSHTrainer
from tests.test_torch_fused_mlp import random_biases
from tests.test_torch_fused_sh_mlp import GRAD_MAX_TOL, assert_grads_near
from tests.test_torch_nerf_sh import both_rays, ray_arrays

NC, NF = 8, 16
# lr_init 100x the default: schedule(0), 1e-2 of it in the delay, is 5e-4, so
# one update is some 1e4 float32 ulps of a parameter near 0.1
TRAINER = dict(sparsity_weight=0.1, sparsity_npoints=32, sparsity_radius=1.5, weight_decay_mult=1e-2,
               randomized=False, lr_init=5e-2, lr_delay_steps=10, max_steps=100)
# the modules' gradients: float32 on both sides, sums in another order
MODULE_FRO_TOL = 1e-4
MODULE_MAX_TOL = 1e-3
STAT_TOL = {False: 1e-5, True: 2e-3}  # relative: float32 modules; the fused trunk's bf16 products
# loss_sp = w (1 - mean(exp(...))) cancels against 1: a float32 ulp of the
# mean, times w, is ~6e-9 absolute
STAT_ATOL = 1e-8
# Adam's first step moves a parameter by u = -lr g / (|g| + eps), eps 1e-8.
# Where both |g| >= STEP_MIN_GRAD and the signs agree, two such updates
# differ by at most lr eps / STEP_MIN_GRAD = 1e-4 lr, whatever the
# gradients' own difference; they are held within STEP_TOL_LR lr, plus one
# float32 ulp of the updated parameter (the port's update is read back as
# new - old)
STEP_MIN_GRAD = 1e-4
STEP_TOL_LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    old = jfsm.INTERPRET
    jfsm.INTERPRET = True
    yield
    jfsm.INTERPRET = old


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def init():
    """The flax SH model's params (flax's init, random biases)."""
    jmodel = jsh.NeRFSHModel(num_coarse_samples=NC, num_fine_samples=NF, sh_deg=2)
    jr, _ = both_rays(ray_arrays(0, n=4))
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    params = jax.jit(lambda a, b, c, r: jmodel.init(a, b, c, r, False))(k[0], k[1], k[2], jr)
    return random_biases(jax.tree_util.tree_map(np.asarray, params), 0)


def _flat(tree):
    """{port parameter name: numpy array in nn.Linear layout} of a flax tree."""
    return {k: v.numpy() for k, v in tsh.nerf_sh_flax_to_state_dict(tree).items()}


def _one_step(params, fused, jit=True):
    """One step on both sides: (stats, grads, updated params, the step's
    stats) of JAX and of the port, as numpy by the port's parameter names.
    Both sides see the port's fine depths: through the fine level's
    resample, bf16 noise in the coarse weights moves the fine samples
    (ROADMAP, "Limits of comparison")."""
    jr, tr = both_rays(ray_arrays(30, n=8))
    pixels = np.random.default_rng(31).uniform(0, 1, (8, 3)).astype(np.float32)
    jmodel = jsh.NeRFSHModel(num_coarse_samples=NC, num_fine_samples=NF, sh_deg=2, use_fused_trunk=fused)
    jtrainer = JTrainer(jmodel, **TRAINER)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    # train_step's key split of a state's key: its k2 draws the sparsity points
    _, k0, k1, k2 = jax.random.split(jax.random.PRNGKey(5), 4)
    r = TRAINER["sparsity_radius"]
    pts = np.array(jax.random.uniform(k2, (TRAINER["sparsity_npoints"], 3), minval=-r, maxval=r))

    fine_z = []

    def port_sample_pdf(*args, **kwargs):
        z, points = tsampling.sample_pdf(*args, **kwargs)
        fine_z.append(z.detach().numpy().copy())
        return z, points

    def jax_sample_pdf(key, bins, weights, origins, directions, z_vals, n, **kwargs):
        z = jnp.asarray(fine_z[-1])
        return z, jsampling.cast_rays(z, origins, directions)

    model = build_model(NeRFSHFlags(num_coarse_samples=NC, num_fine_samples=NF, sh_deg=2, use_viewdirs=False,
                                    use_fused_trunk=fused))
    trainer = NeRFSHTrainer(model, device="cpu", **TRAINER)
    state = trainer.init_state(0)
    state.model.load_state_dict(tsh.nerf_sh_flax_to_state_dict(params), strict=True)
    grad_fn = jax.value_and_grad(jtrainer.loss_fn, has_aux=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsh, "sample_pdf", port_sample_pdf)
        stats, grads = trainer.value_and_grad(state.model, None, tr, torch.from_numpy(pixels),
                                              sparsity_points=torch.from_numpy(pts))
        state, stats2 = trainer.train_step(state, tr, torch.from_numpy(pixels), sparsity_points=torch.from_numpy(pts))
        mp.setattr(jsh, "sample_pdf", jax_sample_pdf)
        (_, jstats), jgrads = (jax.jit(grad_fn) if jit else grad_fn)(jparams, (k0, k1, k2), jr, jnp.asarray(pixels))
    # train_step's update: optax.adam at the schedule of its count
    updates, _ = jtrainer.tx.update(jgrads, jtrainer.tx.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)
    np.testing.assert_array_equal(fine_z[0], fine_z[-1])
    return dict(
        fused=fused, lr=float(jtrainer.schedule(0)), init=_flat(params), updates=_flat(updates),
        jax=({k: float(v) for k, v in jstats.items()}, _flat(jgrads), _flat(jnew)),
        port=({k: float(v) for k, v in stats.items()}, {k: v.numpy() for k, v in grads.items()},
              {k: v.detach().numpy() for k, v in state.model.state_dict().items()},
              {k: float(v) for k, v in stats2.items()}),
        step=state.step,
    )


@pytest.fixture(scope="module", params=[False, True], ids=["modules", "fused trunk"])
def step(request, init):
    """``_one_step`` from the flax init, through the modules or the fused
    trunk. With these draws the coarse MLP's sigma is negative at every
    sample of the step's rays: its gradient is weight decay alone, and
    test_live_coarse_level_gradients_match_jax gives it one from the MSE."""
    return _one_step(init, request.param)


def test_step_loss_and_stats_match_jax(step):
    jstats, _, _ = step["jax"]
    stats, _, _, stats2 = step["port"]
    assert set(stats) == set(stats2) == set(jstats) == {"loss", "psnr", "loss_c", "psnr_c", "loss_sp", "weight_l2"}
    tol = STAT_TOL[step["fused"]]
    for k in jstats:
        np.testing.assert_allclose(stats[k], jstats[k], rtol=tol, atol=STAT_ATOL, err_msg=k)
        np.testing.assert_allclose(stats2[k], jstats[k], rtol=tol, atol=STAT_ATOL, err_msg=k)


def _assert_module_grads_match(grads, jgrads):
    assert set(grads) == set(jgrads)
    for name in jgrads:
        g, w = grads[name].astype(np.float64), jgrads[name].astype(np.float64)
        fro = np.linalg.norm(g - w) / np.linalg.norm(w)
        worst = np.abs(g - w).max() / np.abs(w).max()
        assert fro < MODULE_FRO_TOL and worst < MODULE_MAX_TOL, (name, fro, worst)


def test_step_gradients_match_jax(step):
    _, jgrads, _ = step["jax"]
    _, grads, _, _ = step["port"]
    if not step["fused"]:
        _assert_module_grads_match(grads, jgrads)
        return
    assert set(grads) == set(jgrads)
    for name in jgrads:
        assert_grads_near(grads[name], jgrads[name], name)


def test_live_coarse_level_gradients_match_jax(init):
    """The step through the modules with the sigma heads' biases lifted by
    0.5, so that both levels' MSE reach their MLPs. JAX runs op by op here:
    its jit run of the same step puts the fine MLP's first-layer outputs up
    to 4.5e-5 from the op-by-op run's (the encodings are computed in other
    fusions), and the fine dense 0 gradient 1.2% (relative Frobenius) from
    it; the port's is within 1e-6 of the op-by-op run's there."""
    tree = jax.tree_util.tree_map(np.copy, init)
    for mlp in ("mlp_coarse", "mlp_fine"):
        tree["params"][mlp]["Dense_8"]["bias"] += np.float32(0.5)
    out = _one_step(tree, False, jit=False)
    jstats, jgrads, _ = out["jax"]
    stats, grads, _, _ = out["port"]
    assert np.isfinite(list(stats.values())).all()
    for k in jstats:
        np.testing.assert_allclose(stats[k], jstats[k], rtol=STAT_TOL[False], atol=STAT_ATOL, err_msg=k)
    # the coarse MLP now has an MSE gradient far above weight decay's ~1e-9
    assert np.abs(jgrads["mlp_coarse.dense.0.weight"]).max() > 1e-4
    _assert_module_grads_match(grads, jgrads)


def _adam_first_update(g, lr):
    """Adam's first step (optax.adam and torch.optim.Adam alike): the
    bias-corrected moments are g and g^2, so u = -lr g / (|g| + eps)."""
    return -lr * g / (np.abs(g) + 1e-8)


def test_step_updates_params_as_jax(step):
    """Adam's first update at schedule(0), compared as updates: the port's
    is Adam's first step of its own gradient, every parameter with a
    gradient moved, none moved against JAX's update where the two
    gradients are held to agree in sign, and where both gradients are well
    above eps the update is JAX's."""
    _, jgrads, jnew = step["jax"]
    _, grads, new, _ = step["port"]
    lr, old, jupdates = step["lr"], step["init"], step["updates"]
    assert step["step"] == 1
    assert lr == pytest.approx(5e-4, rel=1e-6)
    # the gradient tests' worst-entry bound: a gradient entry larger than
    # it (of the tensor's largest) cannot change sign between the sides
    sign_tol = GRAD_MAX_TOL if step["fused"] else MODULE_MAX_TOL
    assert set(new) == set(jnew) == set(old)
    n_same = 0
    for name in jnew:
        gj, gp = jgrads[name].astype(np.float64), grads[name].astype(np.float64)
        uj = jupdates[name].astype(np.float64)
        up = new[name].astype(np.float64) - old[name].astype(np.float64)
        ulp = np.spacing(np.maximum(np.abs(new[name]), np.abs(old[name]))).astype(np.float64)
        # each side's update is Adam's first step of its own gradient
        assert (np.abs(up - _adam_first_update(gp, lr)) <= 1e-5 * lr + ulp).all(), name
        assert (np.abs(uj - _adam_first_update(gj, lr)) <= 1e-5 * lr).all(), name
        moving = np.abs(gp) > 1e-9  # an update of > 0.09 lr, some 400 ulps of a parameter near 0.1
        assert moving.mean() > 0.25, (name, float(moving.mean()))
        assert (up[moving] != 0).all(), name
        sure = np.abs(gj) > sign_tol * np.abs(gj).max()
        assert (np.sign(up[sure]) == np.sign(uj[sure])).all(), name
        same = sure & (np.abs(gj) > STEP_MIN_GRAD) & (np.abs(gp) > STEP_MIN_GRAD)
        err = np.abs(up - uj) - ulp
        assert (err[same] <= STEP_TOL_LR * lr).all(), (name, float(err[same].max() / lr))
        assert (np.abs(up[same]) > 0.9 * lr).all(), name
        n_same += int(same.sum())
    assert n_same > 1000, n_same


def test_loss_falls_over_cpu_steps():
    """A small SH model trained on the synthetic scene with the generator's
    stratified, pdf and sparsity draws: the fine MSE falls."""
    ds = make_dataset(n_views=2, image_size=16, device="cpu")
    model = tsh.NeRFSHModel(num_coarse_samples=16, num_fine_samples=16, sh_deg=1, net_depth=3, net_width=32,
                            skip_layer=2)
    trainer = NeRFSHTrainer(model, lr_init=5e-3, lr_final=5e-4, max_steps=60, lr_delay_steps=0,
                            sparsity_weight=1e-3, sparsity_npoints=64, weight_decay_mult=1e-4, device="cpu")
    state = trainer.init_state(1)
    n_pool = ds["pixels"].shape[0]
    losses = []
    for _ in range(60):
        idx = torch.randint(0, n_pool, (64,), generator=state.generator)
        state, stats = trainer.train_step(state, ds["rays"].map(lambda t: t[idx]), ds["pixels"][idx])
        losses.append(float(stats["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:10]), (losses[:10], losses[-10:])


def test_render_image_sh_matches_jax(init):
    """A 6x7 camera rendered in requests of 16 rays (the tail padded with
    copies of its last ray), through the float32 modules on both sides."""
    params = init
    K = np.array([[6.0, 0, 3.5], [0, 6.0, 3.0], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, -0.1, 4.0]
    images = np.zeros((1, 6, 7, 3), np.float32)
    jscene = JSceneData(images=images, poses=pose[None], intrinsics=K, near=2.0, far=6.0)
    scene = SceneData(images=images, poses=pose[None], intrinsics=K, near=2.0, far=6.0)
    jtrainer = JTrainer(jsh.NeRFSHModel(num_coarse_samples=NC, num_fine_samples=NF, sh_deg=2), **TRAINER)
    want = jcli.render_image_sh(jtrainer, jax.tree_util.tree_map(jnp.asarray, params), jscene, 0, chunk=16)
    model = tsh.NeRFSHModel(num_coarse_samples=NC, num_fine_samples=NF, sh_deg=2)
    model.load_state_dict(tsh.nerf_sh_flax_to_state_dict(params), strict=True)
    trainer = NeRFSHTrainer(model, device="cpu", **TRAINER)
    got = tcli.render_image_sh(trainer, model, scene, 0, chunk=16, device="cpu")
    assert tuple(got.shape) == (6, 7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    pool, rgb = tcli.build_ray_pool(scene, device="cpu")
    jpool, jrgb = jcli.build_ray_pool(jscene)
    for g, w in zip(pool, jpool):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))


def test_trainer_device_none_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NeRFSHTrainer(tsh.NeRFSHModel(sh_deg=1))
