"""The port's NeRF-SH model and its ops (``ops/sg.py``, the jaxnerf pdf and
disparity numerics, ``models/nerf_sh.py``) against the JAX package, on the
same numpy inputs and weights (CPU).

The fused trunk runs its plain PyTorch versions here and JAX's K5 runs in
interpret mode. Weights come from flax's init with every bias drawn from a
seeded normal (flax zeroes them). Full width (depth 8, width 256) where
the fused gate needs it, with 8 rays and 8 + 16 samples.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nerf_projects_tpu.ops.pallas.fused_sh_mlp as jfsm
from nerf_projects_tpu.core.rays import Rays as JRays
from nerf_projects_tpu.models import nerf_sh as jsh
from nerf_projects_tpu.ops import render as jrender
from nerf_projects_tpu.ops import sampling as jsampling
from nerf_projects_tpu.ops import sg as jsg
from nerf_projects_tpu.utils.interop import nerf_sh_params_from_jaxnerf as jax_from_jaxnerf
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.models import nerf_sh as tsh
from nerf_projects_tpu_torch.ops import render as trender
from nerf_projects_tpu_torch.ops import sampling as tsampling
from nerf_projects_tpu_torch.ops import sg as tsg
from tests.test_torch_fused_mlp import random_biases

TOL = 1e-5        # float32 on both sides: summation order and transcendentals
DEPTH_TOL = 6e-5  # absolute, on depths in [2, 6]: 1e-5 of far
# the fused trunk: the same bf16 products on both sides, float32 sums in
# another order; a bf16 rounding that flips moves a sample's raw output by
# ~2e-3 of scale (tests/test_torch_fused_sh_mlp.py), and the fine level's
# depths follow the coarse weights
FUSED_TOL = 5e-3
N_RAYS, NC, NF = 8, 8, 16
MODES = {"sh": dict(sh_deg=2), "sg": dict(sg_dim=4), "viewdirs": dict(use_viewdirs=True)}


@pytest.fixture(autouse=True)
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


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol=TOL, atol=None):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got, np.asarray(want),
                               rtol=tol, atol=tol if atol is None else atol)


def ray_arrays(seed, n=N_RAYS):
    """Rays from cameras at radius 4 looking at the origin, as numpy."""
    rng = np.random.default_rng(seed)
    look = rng.standard_normal((n, 3))
    origins = 4.0 * look / np.linalg.norm(look, axis=-1, keepdims=True)
    dirs = -origins / 4.0 + 0.2 * rng.standard_normal((n, 3))
    viewdirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (origins, dirs, viewdirs)]


def both_rays(arrays):
    return JRays(*(jnp.asarray(a) for a in arrays)), Rays(*(_t(a) for a in arrays))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mu_dim", [2, 3])
def test_eval_sg_matches_jax(mu_dim):
    rng = np.random.default_rng(mu_dim)
    lam = rng.standard_normal(4).astype(np.float32)
    mu = rng.uniform(0, 3, (4, mu_dim)).astype(np.float32)
    coeffs = rng.standard_normal((5, 6, 3, 4)).astype(np.float32)
    dirs = rng.standard_normal((5, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = jsg.eval_sg(jnp.asarray(lam), jnp.asarray(mu), jnp.asarray(coeffs), jnp.asarray(dirs))
    got = tsg.eval_sg(_t(lam), _t(mu), _t(coeffs), _t(dirs))
    assert tuple(got.shape) == want.shape == (5, 6, 3)
    _close(got, want)
    _close(tsg.spher2cart(2.0, _t(mu[:, 0]), _t(mu[:, 1])), jsg.spher2cart(2.0, mu[:, 0], mu[:, 1]))


def _pdf_inputs(seed, zero_rows):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(2.0, 6.0, (6, 12)), axis=-1).astype(np.float32)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    weights = rng.uniform(0, 1, (6, 10)).astype(np.float32) ** 4  # one fewer than bins, as jaxnerf
    weights[:zero_rows] = 0.0
    weights[zero_rows, 3:6] = 0.0  # a flat stretch of the cdf
    return z, bins, weights


@pytest.mark.parametrize("randomized", [False, True])
def test_piecewise_constant_pdf_jaxnerf_matches_jax(randomized):
    """Both sides fed the same uniforms; two rows have all-zero weights
    (the padded sum) and one a flat stretch, where nan_to_num runs."""
    _, bins, weights = _pdf_inputs(7, zero_rows=2)
    key = jax.random.PRNGKey(3)
    want = jsampling.piecewise_constant_pdf(key, jnp.asarray(bins), jnp.asarray(weights), 16,
                                            randomized=randomized, mode="jaxnerf")
    u = jax.random.uniform(key, (6, 16)) if randomized else None
    got = tsampling.piecewise_constant_pdf(None, _t(bins), _t(weights), 16, randomized=randomized,
                                           mode="jaxnerf", u=None if u is None else _t(u))
    assert bool(torch.isfinite(got).all())
    _close(got, want, atol=DEPTH_TOL)


def test_sample_pdf_matches_jax():
    z, bins, weights = _pdf_inputs(8, zero_rows=1)
    origins, dirs, _ = ray_arrays(9, n=6)
    want_z, want_pts = jsampling.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights),
                                            jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(z), 16,
                                            randomized=False, mode="jaxnerf")
    got_z, got_pts = tsampling.sample_pdf(None, _t(bins), _t(weights), _t(origins), _t(dirs), _t(z), 16,
                                          randomized=False, mode="jaxnerf")
    assert tuple(got_z.shape) == (6, 28) and bool((got_z[:, 1:] >= got_z[:, :-1]).all())
    _close(got_z, want_z, atol=DEPTH_TOL)
    _close(got_pts, want_pts, atol=DEPTH_TOL)


def test_volumetric_rendering_jaxnerf_matches_jax():
    """Random densities, with two rays of zero density (acc = 0, where the
    disparity is 1e10)."""
    rng = np.random.default_rng(10)
    z, _, _ = _pdf_inputs(10, zero_rows=0)
    sigma = rng.uniform(0, 2, z.shape).astype(np.float32)
    sigma[:2] = 0.0
    rgb = rng.uniform(0, 1, z.shape + (3,)).astype(np.float32)
    _, dirs, _ = ray_arrays(11, n=6)
    for white in (False, True):
        want = jrender.volumetric_rendering(jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(z), jnp.asarray(dirs),
                                            white_bkgd=white, disp_mode="jaxnerf")
        got = trender.volumetric_rendering(_t(rgb), _t(sigma), _t(z), _t(dirs), white_bkgd=white,
                                           disp_mode="jaxnerf")
        for name in ("rgb", "disp", "acc", "weights", "depth"):
            _close(getattr(got, name), getattr(want, name))
        assert float(got.disp[0]) == 1e10 and float(got.acc[0]) == 0.0


# ---------------------------------------------------------------------------
# CondMLP and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_condition", [False, True])
def test_cond_mlp_matches_flax(with_condition):
    kw = dict(net_depth=4, net_width=32, net_width_condition=16, skip_layer=2, num_rgb_channels=12)
    flax_mlp = jsh.CondMLP(**kw)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((10, 63)).astype(np.float32)
    cond = rng.standard_normal((10, 27)).astype(np.float32) if with_condition else None
    params = flax_mlp.init(jax.random.PRNGKey(0), jnp.asarray(x), None if cond is None else jnp.asarray(cond))
    params = random_biases(jax.tree_util.tree_map(np.asarray, params), 12)
    port = tsh.CondMLP(in_ch=63, in_ch_condition=27 if with_condition else None, **kw)
    port.load_state_dict(tsh.cond_mlp_flax_to_state_dict(params), strict=True)
    want = flax_mlp.apply(params, jnp.asarray(x), None if cond is None else jnp.asarray(cond))
    with torch.no_grad():
        got = port(_t(x), None if cond is None else _t(cond))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.fixture(scope="module")
def models():
    """Per mode: the flax params (random biases, from flax's init) and the
    port's NeRFSHModel holding them."""
    out = {}
    jr, _ = both_rays(ray_arrays(0, n=4))
    for seed, (mode, kw) in enumerate(MODES.items()):
        flax_model = jsh.NeRFSHModel(num_coarse_samples=NC, num_fine_samples=NF, **kw)
        k = jax.random.split(jax.random.PRNGKey(seed), 3)
        params = jax.jit(lambda a, b, c, r: flax_model.init(a, b, c, r, False))(k[0], k[1], k[2], jr)
        params = random_biases(jax.tree_util.tree_map(np.asarray, params), seed)
        port = tsh.NeRFSHModel(num_coarse_samples=NC, num_fine_samples=NF, **kw)
        port.load_state_dict(tsh.nerf_sh_flax_to_state_dict(params), strict=True)
        out[mode] = (params, port)
    return out


def _render_both(models, mode, fused, seed):
    params, port = models[mode]
    kw = MODES[mode]
    jmodel = jsh.NeRFSHModel(num_coarse_samples=NC, num_fine_samples=NF, use_fused_trunk=fused, **kw)
    jr, tr = both_rays(ray_arrays(seed))
    want = jmodel.apply(params, None, None, jr, False)
    port.use_fused_trunk = fused
    try:
        with torch.no_grad():
            got = port(tr, False)
    finally:
        port.use_fused_trunk = False
    return got, want


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused trunk"])
@pytest.mark.parametrize("mode", list(MODES))
def test_model_coarse_fine_matches_jax(models, mode, fused):
    """Coarse and fine rgb, disp and acc at randomized=False. In viewdirs
    mode the fused gate refuses on both sides and the modules run."""
    got, want = _render_both(models, mode, fused, seed=20)
    assert len(got) == len(want) == 2
    tol = FUSED_TOL if fused and mode != "viewdirs" else 1e-4
    for g, w in zip(got, want):
        for name in ("rgb", "acc"):
            _close(getattr(g, name), getattr(w, name), tol=0, atol=tol)
        # disparity is acc / depth: relative
        _close(g.disp, w.disp, tol=tol, atol=0)


def test_fused_gate_follows_the_reference(models):
    _, port = models["sh"]
    assert not port._fused_trunk_ok()
    kw = dict(num_coarse_samples=NC, num_fine_samples=NF, use_fused_trunk=True)
    assert tsh.NeRFSHModel(sh_deg=3, **kw)._fused_trunk_ok()
    assert tsh.NeRFSHModel(sg_dim=4, **kw)._fused_trunk_ok()
    for other in (dict(use_viewdirs=True), dict(sh_deg=7), dict(sh_deg=2, net_activation=F.elu),
                  dict(sh_deg=2, net_width=128), dict(sh_deg=2, max_deg_point=8),
                  dict(sh_deg=2, num_sigma_channels=2)):
        assert not tsh.NeRFSHModel(**kw, **other)._fused_trunk_ok(), other


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused trunk"])
@pytest.mark.parametrize("mode", ["sh", "viewdirs"])
def test_eval_points_match_jax(models, mode, fused):
    params, port = models[mode]
    jmodel = jsh.NeRFSHModel(num_coarse_samples=NC, num_fine_samples=NF, use_fused_trunk=fused, **MODES[mode])
    rng = np.random.default_rng(21)
    pts = rng.uniform(-1.5, 1.5, (16, 3)).astype(np.float32)
    vd = rng.standard_normal((16, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    tol = FUSED_TOL if fused and mode != "viewdirs" else 1e-4
    port.use_fused_trunk = fused
    try:
        with torch.no_grad():
            for coarse in (False, True):
                want = jmodel.apply(params, jnp.asarray(pts), jnp.asarray(vd), coarse, method=jmodel.eval_points_raw)
                got = port.eval_points_raw(_t(pts), _t(vd), coarse)
                for g, w in zip(got, want):
                    scale = float(np.abs(np.asarray(w)).max())
                    _close(g, w, tol=0, atol=tol * scale)
            want = jmodel.apply(params, jnp.asarray(pts), jnp.asarray(vd), method=jmodel.eval_points)
            got = port.eval_points(_t(pts), _t(vd))
            for g, w in zip(got, want):
                _close(g, w, tol=0, atol=tol * max(1.0, float(np.abs(np.asarray(w)).max())))
    finally:
        port.use_fused_trunk = False


@pytest.mark.parametrize("rgb_act,sigma_act,ok", [
    ("sigmoid", "relu", True), ("sigmoid", "softplus", True), ("relu", "relu", False),
    ("softplus", "relu", False), ("sigmoid", "elu", False),
])
def test_validate_activations_matches_jax(rgb_act, sigma_act, ok):
    jacts = {"relu": jax.nn.relu, "sigmoid": jax.nn.sigmoid, "softplus": jax.nn.softplus, "elu": jax.nn.elu}
    for validate, acts in ((jsh.validate_activations, jacts), (tsh.validate_activations, tsh.ACTIVATIONS)):
        if ok:
            validate(acts[rgb_act], acts[sigma_act])
        else:
            with pytest.raises(ValueError):
                validate(acts[rgb_act], acts[sigma_act])


def test_weight_carry_from_a_jaxnerf_tree(models):
    """A jaxnerf / PlenOctree checkpoint tree ({MLP_0, MLP_1, SG lobes})
    renames as JAX's interop does and loads into the same state."""
    params, port = models["sg"]
    p = params["params"]
    ckpt = {"params": {"MLP_0": p["mlp_coarse"], "MLP_1": p["mlp_fine"], "sg_lambda": p["sg_lambda"],
                       "sg_mu_spher": p["sg_mu_spher"]}}
    want = jax_from_jaxnerf(ckpt)
    got = tsh.nerf_sh_params_from_jaxnerf(ckpt)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    state = tsh.nerf_sh_flax_to_state_dict(ckpt)
    assert set(state) == set(port.state_dict())
    for name, value in port.state_dict().items():
        torch.testing.assert_close(state[name], value, rtol=0, atol=0)


def test_model_forward_copies_no_host_numbers_after_its_first_call(monkeypatch):
    """On the card a copy of host numbers (torch.tensor, torch.as_tensor)
    waits for the queue to drain; a render makes none after its first."""
    model = tsh.NeRFSHModel(num_coarse_samples=4, num_fine_samples=4, sh_deg=1, net_depth=2, net_width=16,
                            skip_layer=1).reset_parameters(torch.Generator().manual_seed(0))
    _, rays = both_rays(ray_arrays(22, n=3))
    with torch.no_grad():
        first = model(rays, False)
        copies = []
        for name in ("tensor", "as_tensor"):
            real = getattr(torch, name)

            def counted(*args, _real=real, _name=name, **kwargs):
                copies.append(_name)
                return _real(*args, **kwargs)

            monkeypatch.setattr(torch, name, counted)
        again = model(rays, False)
        monkeypatch.undo()
    assert copies == []
    torch.testing.assert_close(first[-1].rgb, again[-1].rgb, rtol=0, atol=0)
