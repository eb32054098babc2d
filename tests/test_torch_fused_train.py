"""The port's fused train level (plain version of the CUDA kernel) against
the reference's fused_train_level in Pallas interpret mode (CPU), in both
input modes, at S=8 with R=8 and with R=4 (the per-ray blocks padded to
8 rows). The CUDA kernel is held against the plain version on the card
by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_projects_tpu.ops.pallas.fused_mlp as jfm
import nerf_projects_tpu.ops.pallas.fused_train as jft
import nerf_projects_tpu_torch.ops.kernels.fused_mlp as tfm
import nerf_projects_tpu_torch.ops.kernels.fused_train as tft
from nerf_projects_tpu.models.nerf import NeRFMLP as FlaxNeRFMLP
from nerf_projects_tpu_torch.models.nerf import NeRFMLP, flax_to_state_dict
from tests.test_torch_fused_mlp import random_biases

S = 8
N_RAYS = 96


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jfm.INTERPRET, jft.INTERPRET
    jfm.INTERPRET = jft.INTERPRET = True
    yield
    jfm.INTERPRET, jft.INTERPRET = old


@pytest.fixture(scope="module")
def models():
    flax_model = FlaxNeRFMLP(depth=8, width=256, use_viewdirs=True)
    tree = random_biases(jax.tree_util.tree_map(np.asarray, jax.jit(flax_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 63)), jnp.zeros((1, 27)))), 0)
    port = NeRFMLP(depth=8, width=256, use_viewdirs=True)
    port.load_state_dict(flax_to_state_dict(tree))
    return tree, port


def level_inputs(seed):
    """Rays from the origin region through depths 2..6, as numpy."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (0.3 * rng.standard_normal((N_RAYS, 3))).astype(np.float32)
    z = (np.linspace(2.0, 6.0, S)[None] + 0.1 * rng.uniform(size=(N_RAYS, S))).astype(np.float32)
    pts = o[:, None] + z[..., None] * d[:, None]
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    return pts, d, z, target


def assert_grads_close(got, want, name):
    """Gradients of two implementations that round to bf16 at the same
    points but sum float32 in another order: all but 0.5% of entries (or
    one, in a small tensor) within 5e-3 of the tensor's largest entry (the bound of
    tests/test_fused_train.py, which compares two runs of the same JAX
    code), and every entry within 2e-2. The port's plain version against
    itself with float64 sums already differs by up to 1.07e-2 of scale on
    these inputs: a bf16 rounding or relu mask that flips moves a whole
    column of dW."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    d = np.abs(got - want) / (np.abs(want).max() + 1e-12)
    assert (d > 5e-3).sum() <= max(1, 0.005 * d.size), (name, int((d > 5e-3).sum()))
    assert d.max() < 2e-2, (name, float(d.max()))


def _both(models, raw, R, bkgd, seed, want_weights=True):
    tree, port = models
    pts, d, z, target = level_inputs(seed)
    jpack = jft.pack_level_inputs_raw if raw else jft.pack_level_inputs
    tpack = tft.pack_level_inputs_raw if raw else tft.pack_level_inputs
    jx, jvt = jpack(*(jnp.asarray(a) for a in (pts, d, z, d, target)), S, R)
    tx, tvt = tpack(*(torch.from_numpy(a) for a in (pts, d, z, d, target)), S, R)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tvt.numpy(), np.asarray(jvt), rtol=1e-6, atol=1e-6)
    kw = dict(S=S, R=R, n_rays_total=N_RAYS, bkgd=bkgd, want_weights=want_weights, raw_inputs=raw)
    want = jft.fused_train_level(jfm.pack_params(tree, raw_layout=raw), jx, jvt, **kw)
    got = tft.train_level(port, tx, tvt, **kw)
    return want, got


@pytest.mark.parametrize("raw,R,bkgd", [
    (True, 8, 1.0), (False, 8, 1.0), (True, 4, 1.0), (False, 4, 0.0),
])
def test_plain_version_matches_jax(models, raw, R, bkgd):
    """rgb, acc and weights at 2e-3 (the bound of tests/test_fused_train.py);
    the 24 padded gradients as assert_grads_close says."""
    want, got = _both(models, raw, R, bkgd, seed=R + int(raw))
    for name, w, g in zip(("rgb", "acc", "weights"), want[:3], got[:3]):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3, err_msg=name)
    for name, w, g in zip(jfm.FusedMLPWeights._fields, want[3], got[3]):
        assert g.dtype == torch.float32, name
        assert_grads_close(g.numpy(), w, name)


def test_no_weights_output(models):
    _, got = _both(models, True, 8, 1.0, seed=3, want_weights=False)
    rgb, acc, w, grads = got
    assert w is None and tuple(rgb.shape) == (N_RAYS, 3) and tuple(acc.shape) == (N_RAYS,)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_grads_unpack_to_the_model_layout(models):
    """Raw-layout gradients unpacked with raw_layout=True match the
    reference's unpack_grads of its own, parameter by parameter."""
    tree, port = models
    want, got = _both(models, True, 8, 1.0, seed=4)
    jg = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jfm.unpack_grads(want[3], tree, raw_layout=True)))
    tg = tfm.unpack_grads(got[3], port, raw_layout=True)
    for name, p in port.named_parameters():
        assert tuple(tg[name].shape) == tuple(p.shape), name
        assert_grads_close(tg[name].numpy(), jg[name].numpy(), name)


def test_shape_checks(models):
    _, port = models
    x = torch.zeros(S * 8 * 2, 8)
    with pytest.raises(ValueError, match="vt_ray"):
        tft.train_level(port, x, torch.zeros(2, 8, 32), S=S, R=8, n_rays_total=16, bkgd=1.0,
                        want_weights=False, raw_inputs=True)
    with pytest.raises(ValueError, match="divisible"):
        tft.train_level(port, x[:-1], torch.zeros(2, 8, 8), S=S, R=8, n_rays_total=16, bkgd=1.0,
                        want_weights=False, raw_inputs=True)
    with pytest.raises(ValueError, match="CUDA"):
        tft.fused_train_level(tfm.kernel_weights_sm90(port), tfm.kernel_weights_sm90_bwd(port), x,
                              torch.zeros(2, 8, 8), S=S, R=8, n_rays_total=16, bkgd=1.0,
                              want_weights=False, raw_inputs=True)
