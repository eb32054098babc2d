"""The port's NeRFMLP and fused-MLP forward against the JAX package (CPU).

On the CPU the fused MLP runs its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode, as tests/test_fused_mlp.py does.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_projects_tpu.ops.pallas.fused_mlp as jfm
import nerf_projects_tpu_torch.ops.kernels.fused_mlp as tfm
from nerf_projects_tpu.models.nerf import NeRFMLP as FlaxNeRFMLP
from nerf_projects_tpu_torch.models.nerf import NeRFMLP, flax_to_state_dict


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jfm.INTERPRET
    jfm.INTERPRET = True
    yield
    jfm.INTERPRET = old


def _flax_params(model, seed=0, in_ch=63, in_ch_views=27):
    """Flax init, with every bias (zero there) drawn from a seeded normal
    so that bias placement shows in each comparison."""
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, in_ch)), jnp.zeros((1, in_ch_views)))
    return random_biases(jax.tree_util.tree_map(np.asarray, params), seed)


def random_biases(tree, seed, std=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0.0, std, a.shape).astype(a.dtype)
                         if path[-1].key == "bias" else a),
        tree,
    )


def _carried(tree, **kwargs):
    model = NeRFMLP(**kwargs)
    model.load_state_dict(flax_to_state_dict(tree), strict=True)
    return model


@pytest.fixture(scope="module")
def full_width():
    """The 8x256 viewdirs MLP: flax params and the port's model holding them."""
    tree = _flax_params(FlaxNeRFMLP(depth=8, width=256, use_viewdirs=True))
    return tree, _carried(tree, depth=8, width=256, use_viewdirs=True)


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 63)).astype(np.float32),
            rng.standard_normal((n, 27)).astype(np.float32))


@pytest.mark.parametrize("use_viewdirs", [True, False])
@pytest.mark.parametrize("skips", [(2,), (4,)])
def test_nerf_mlp_matches_flax(use_viewdirs, skips):
    """depth 4, width 64, float32 both sides, weights carried across;
    1e-4 covers float32 summation-order differences through 6 layers."""
    kw = dict(depth=4, width=64, skips=skips, use_viewdirs=use_viewdirs)
    flax_model = FlaxNeRFMLP(**kw)
    pts, views = _inputs(0, 96)
    if use_viewdirs:
        tree = _flax_params(flax_model, seed=1)
        want = flax_model.apply(tree, pts, views)
    else:
        tree = random_biases(jax.tree_util.tree_map(
            np.asarray, jax.jit(flax_model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 63)))
        ), 1)
        want = flax_model.apply(tree, pts)
    got = _carried(tree, **kw)(torch.from_numpy(pts), torch.from_numpy(views))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_flax_to_state_dict_transposes_kernels(full_width):
    tree, model = full_width
    np.testing.assert_array_equal(
        model.trunk[5].weight.detach().numpy(), tree["params"]["trunk_5"]["kernel"].T
    )
    np.testing.assert_array_equal(
        model.view_0.bias.detach().numpy(), tree["params"]["view_0"]["bias"]
    )


def test_reset_parameters_is_seeded_lecun_normal():
    a = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(torch.Generator().manual_seed(3))
    b = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(torch.Generator().manual_seed(3))
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    w = a.trunk[1].weight.detach()
    assert abs(float(w.std()) - (1 / 256) ** 0.5) < 0.1 * (1 / 256) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 256) ** 0.5 / 0.87962566103423978 + 1e-6
    assert float(a.trunk[1].bias.detach().abs().max()) == 0.0


def test_pack_params_matches_jax(full_width):
    tree, model = full_width
    want = jfm.pack_params(tree)
    got = tfm.pack_params(model)
    for name in jfm.FusedMLPWeights._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name).astype(jnp.float32))
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.float().numpy(), w, err_msg=name)


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / (np.abs(want).mean() + 1.0)


def test_fused_reference_matches_jax_interpret(full_width):
    """One 768-row tile plus a ragged tail. Both sides round to bf16 at
    the same points and accumulate in float32; what differs is summation
    order, and with it the odd bf16 rounding of an activation, so 1e-2 of
    the output scale."""
    tree, model = full_width
    pts, views = _inputs(2, jfm.TILE + 37)
    want = jfm.fused_apply(jfm.pack_params(tree), jnp.asarray(pts), jnp.asarray(views))
    got = tfm.fused_apply_reference(tfm.pack_params(model), torch.from_numpy(pts), torch.from_numpy(views))
    assert tuple(got.shape) == want.shape == (jfm.TILE + 37, 4)
    assert _rel_err(got, want) < 1e-2


def test_fused_reference_matches_fp32_flax(full_width):
    """bf16 products against the float32 flax model: the 0.05 bound of
    tests/test_fused_mlp.py."""
    tree, model = full_width
    pts, views = _inputs(3, jfm.TILE + 37)
    want = FlaxNeRFMLP(depth=8, width=256, use_viewdirs=True).apply(tree, pts, views)
    got = tfm.fused_apply_reference(tfm.pack_params(model), torch.from_numpy(pts), torch.from_numpy(views))
    assert _rel_err(got, want) < 0.05


def test_fused_apply_on_cpu_runs_the_plain_version(full_width):
    _, model = full_width
    W = tfm.pack_params(model)
    pts, views = (torch.from_numpy(a) for a in _inputs(4, 100))
    before = tfm.fused_mlp_fwd.launches
    got = tfm.fused_apply(model, pts, views)
    torch.testing.assert_close(got, tfm.fused_apply_reference(W, pts, views), rtol=0, atol=0)
    raw8 = tfm.fused_nerf_mlp(model, *tfm._pad_inputs(pts, views))
    assert tuple(raw8.shape) == (100, 8)
    # padded head columns are exactly zero
    assert float(raw8[:, 3].abs().max()) == 0.0 and float(raw8[:, 5:].abs().max()) == 0.0
    assert tfm.fused_mlp_fwd.launches == before


def test_fused_mlp_fwd_refuses_host_tensors(full_width):
    _, model = full_width
    wk = tfm.kernel_weights(model)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_fwd(wk, torch.zeros(8, 64), torch.zeros(8, 32))


def test_kernel_layout_matches_cuda_source():
    """KERNEL_LAYOUT's offsets are the OFF_* constants of the CUDA source."""
    src = (Path(tfm.__file__).resolve().parents[2] / "csrc" / "fused_mlp_fwd.cu").read_text()
    env = {}
    for name, expr in re.findall(r"constexpr long long (\w+) = ([^;]+);", src):
        env[name] = eval(expr, {}, dict(env))
    offsets, total = {}, 0
    for name, rows, cols in tfm.KERNEL_LAYOUT:
        offsets[name] = total
        total += rows * cols
    assert env["N_WEIGHTS"] == total
    for name in ("w0", "w1", "w5", "w6", "wb", "wv", "wsig", "wrgb", "bb", "bv", "bsig", "brgb"):
        assert env[f"OFF_{name.upper()}"] == offsets[name], name
    assert env["OFF_B"] == offsets["b0"]


def test_kernel_weights_layout(full_width):
    """Each piece of the flat buffer, built from the nn.Linear weights, is
    the matching pack_params field (held against the JAX pack_params
    above) transposed to [out][in], biases included."""
    _, model = full_width
    W = tfm.pack_params(model)
    wk = tfm.kernel_weights(model)
    assert wk.dtype == torch.bfloat16 and wk.ndim == 1
    at = 0
    for name, rows, cols in tfm.KERNEL_LAYOUT:
        piece = wk[at: at + rows * cols].reshape(rows, cols)
        field = getattr(W, name)
        want = field[:, :cols] if name.startswith("b") else field.T[:rows]
        torch.testing.assert_close(piece, want, rtol=0, atol=0)
        at += rows * cols
    assert at == wk.numel()


def test_kernel_weights_is_kept_until_a_parameter_changes():
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(torch.Generator().manual_seed(0))
    wk = tfm.kernel_weights(model)
    assert tfm.kernel_weights(model) is wk
    with torch.no_grad():
        model.sigma_head.bias.fill_(0.5)
    wk2 = tfm.kernel_weights(model)
    assert wk2 is not wk
    bsig = sum(r * c for n, r, c in tfm.KERNEL_LAYOUT[: [n for n, _, _ in tfm.KERNEL_LAYOUT].index("bsig")])
    assert wk2[bsig].item() == 0.5 and wk[bsig].item() == 0.0
    model.load_state_dict(NeRFMLP(depth=8, width=256, use_viewdirs=True).state_dict())
    assert tfm.kernel_weights(model) is not wk2
