"""The port's NeRFMLP and fused MLP (forward and weight-gradient
backward) against the JAX package (CPU).

On the CPU the fused MLP runs its plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_fused_mlp.py
does. The CUDA kernels themselves are held against the plain versions on
the card by chip_smoke.py.
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


@pytest.mark.parametrize("raw_layout", [False, True], ids=["model_layout", "raw_layout"])
def test_fused_mlp_fwd_refuses_host_tensors(full_width, raw_layout):
    """K1f raises on host tensors over the encoded route's buffer and over
    K1rf's (the raw layout, on which the card's check holds the in-kernel
    encoder to the host's)."""
    _, model = full_width
    wk = tfm.kernel_weights_sm90(model, raw_layout=raw_layout)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_fwd(wk, torch.zeros(8, 64), torch.zeros(8, 32))


def _cuda_constants(namespace="mlp"):
    """The ``constexpr long long`` constants of csrc/mlp_tile.cuh's
    ``namespace`` (mlp: the NeRF MLP's layouts; sh: the NeRF-SH trunk's)."""
    src = (Path(tfm.__file__).resolve().parents[2] / "csrc" / "mlp_tile.cuh").read_text()
    body = re.search(rf"\nnamespace {namespace} {{\n(.*?)\n}}  // namespace {namespace}\n", src, re.S).group(1)
    env = {}
    for name, expr in re.findall(r"constexpr long long (\w+) = ([^;]+);", body):
        env[name] = eval(expr, {}, dict(env))
    return env


def _cuda_layers(table):
    """(n, k, kd) of each entry of a ``constexpr Layer`` table of
    csrc/mlp_sm90.cuh."""
    src = (Path(tfm.__file__).resolve().parents[2] / "csrc" / "mlp_sm90.cuh").read_text()
    body = re.search(rf"constexpr Layer {table}\[\] = \{{(.*?)\n\}};", src, re.S).group(1)
    return [tuple(int(v) for v in e) for e in re.findall(r"\{[^{}]*?,\s*(\d+),\s*(\d+),\s*(\d+)\}", body)]


def test_kernel_layout_matches_cuda_source():
    """KERNEL_LAYOUT, the staging layout the wgmma core's buffer is built
    from, holds each matrix the core's layer table (FWD_LAYERS) takes, in
    its order, as [N][K] (the heads' N padded to 8 there); SM90_LAYOUT and
    SM90_LAYOUT_BWD are FWD_LAYERS and DX_LAYERS."""
    layers = _cuda_layers("FWD_LAYERS")
    assert [(n, k, kd) for _, n, k, kd in tfm.SM90_LAYOUT] == layers
    assert [(n, k, kd) for _, n, k, kd in tfm.SM90_LAYOUT_BWD] == _cuda_layers("DX_LAYERS")
    staged = {name: (rows, cols) for name, rows, cols in tfm.KERNEL_LAYOUT}
    for name, n, k, _ in tfm.SM90_LAYOUT:
        rows, cols = staged[name]
        assert cols == k and (rows == n or (rows == 4 and n == 8)), name
    for name, n in tfm.SM90_BIASES:
        rows, cols = staged[name]
        assert rows == 1 and (cols == n or (cols == 4 and n == 8)), name
    assert {name for name, _ in tfm.SM90_BIASES} | {name for name, *_ in tfm.SM90_LAYOUT} == set(staged)


def test_kernel_weights_layout(full_width):
    """Unslabbed, each piece of the wgmma core's forward buffer, built from
    the nn.Linear weights, is the matching pack_params field (held against
    the JAX pack_params above) transposed to [out][in], the heads' rows and
    biases padded to 8."""
    _, model = full_width
    W = tfm.pack_params(model)
    wk = tfm.kernel_weights_sm90(model)
    assert wk.dtype == torch.bfloat16 and wk.ndim == 1
    offsets, at = _layout_offsets(tfm.SM90_LAYOUT)
    for name, n, k, kd in tfm.SM90_LAYOUT:
        want = getattr(W, name).T[:n]
        want = torch.nn.functional.pad(want, (0, 0, 0, n - want.shape[0]))
        torch.testing.assert_close(_unslab(wk, offsets[name], n, k, kd), want, rtol=0, atol=0, msg=name)
    for name, n in tfm.SM90_BIASES:
        torch.testing.assert_close(wk[at: at + n], getattr(W, name)[0, :n], rtol=0, atol=0, msg=name)
        at += n
    assert at == wk.numel()


def test_kernel_weights_is_kept_until_a_parameter_changes():
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(torch.Generator().manual_seed(0))
    wk = tfm.kernel_weights_sm90(model)
    assert torch.equal(tfm.kernel_weights_sm90(model), wk)
    with torch.no_grad():
        model.sigma_head.bias.fill_(0.5)
    wk2 = tfm.kernel_weights_sm90(model)
    assert wk2 is not wk
    bsig = _sm90_constants()["SW_BSIG"]
    assert wk2[bsig].item() == 0.5 and wk[bsig].item() == 0.0
    model.load_state_dict(NeRFMLP(depth=8, width=256, use_viewdirs=True).state_dict())
    assert not torch.equal(tfm.kernel_weights_sm90(model), wk2)


def test_kernel_weights_rebuild_after_a_write_through_data():
    """``p.data.copy_`` bumps no version counter and keeps the pointer;
    the buffers must still follow it, forward and backward, after one
    write and after another."""
    gen = torch.Generator().manual_seed(3)
    model = NeRFMLP(depth=8, width=256, use_viewdirs=True).reset_parameters(gen)
    fresh = NeRFMLP(depth=8, width=256, use_viewdirs=True)

    def follows_the_parameters(wk, wkt):
        fresh.load_state_dict(model.state_dict())
        torch.testing.assert_close(wk, tfm.kernel_weights_sm90(fresh), rtol=0, atol=0)
        torch.testing.assert_close(wkt, tfm.kernel_weights_sm90_bwd(fresh), rtol=0, atol=0)

    wk, wkt = tfm.kernel_weights_sm90(model), tfm.kernel_weights_sm90_bwd(model)
    model.trunk[1].weight.data.copy_(torch.randn(model.trunk[1].weight.shape, generator=gen))
    model.sigma_head.bias.data.fill_(0.25)
    wk2, wkt2 = tfm.kernel_weights_sm90(model), tfm.kernel_weights_sm90_bwd(model)
    assert not torch.equal(wk2, wk) and not torch.equal(wkt2, wkt)
    follows_the_parameters(wk2, wkt2)
    model.view_0.weight.data.mul_(0.5)
    wk3, wkt3 = tfm.kernel_weights_sm90(model), tfm.kernel_weights_sm90_bwd(model)
    assert not torch.equal(wk3, wk2) and not torch.equal(wkt3, wkt2)
    follows_the_parameters(wk3, wkt3)


# ---------------------------------------------------------------------------
# The weight-gradient backward (K1b) and the raw layout
# ---------------------------------------------------------------------------

def _jax_grad_tree(tree, pts, views, cot):
    def loss(p):
        return jnp.sum(jfm.fused_apply(jfm.pack_params(p), pts, views) * cot)
    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(tree))


@pytest.mark.parametrize("n", [2 * jfm.TILE, jfm.TILE + 37])
def test_fused_apply_gradients_match_jax(full_width, n):
    """A loss through the port's fused_apply gives the model's parameters
    non-zero gradients, those of jax.grad through the reference's
    fused_apply (Pallas forward and backward in interpret mode), over two
    tiles and over a ragged tile. Both round to bf16 at the same points,
    but float32 sums in another order move the odd activation across a
    bf16 rounding boundary or a relu's zero, and one flipped mask moves a
    column of dW by ~1/sqrt(rows) of its size (seen: up to 1.5e-2 on
    trunk_7, below 8e-3 elsewhere). So the bound is relative to each
    tensor's largest entry: the 0.05 of
    tests/test_fused_mlp.py::test_weight_grads_match_flax_bf16."""
    tree, model = full_width
    pts, views = _inputs(5, n)
    cot = np.random.default_rng(6).standard_normal((n, 4)).astype(np.float32)
    want = flax_to_state_dict(_jax_grad_tree(tree, pts, views, cot))

    model.zero_grad(set_to_none=True)
    out = tfm.fused_apply(model, torch.from_numpy(pts), torch.from_numpy(views))
    (out * torch.from_numpy(cot)).sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.shape == p.shape, name
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.abs(g).max() > 0, name
        rel = np.abs(g - w).max() / (np.abs(w).max() + 1e-3)
        assert rel < 0.05, (name, rel)
    model.zero_grad(set_to_none=True)


def test_backward_reference_matches_jax_padded_grads(full_width):
    """fused_mlp_bwd_reference against the reference's backward kernel on
    the padded layout, g on all eight columns (the padded head columns
    carry gradient too)."""
    tree, model = full_width
    n = jfm.TILE
    pts, views = _inputs(7, n)
    x = np.zeros((n, 64), np.float32)
    x[:, :63] = pts
    v = np.zeros((n, 32), np.float32)
    v[:, :27] = views
    g8 = np.random.default_rng(8).standard_normal((n, 8)).astype(np.float32)
    W = jfm.pack_params(tree)
    _, vjp = jax.vjp(lambda w: jfm.fused_nerf_mlp(w, jnp.asarray(x), jnp.asarray(v)), W)
    (want,) = vjp(jnp.asarray(g8))
    got = tfm.fused_mlp_bwd_reference(tfm.pack_params(model), *(torch.from_numpy(a) for a in (x, v, g8)))
    for name in jfm.FusedMLPWeights._fields:
        gw = np.asarray(getattr(want, name).astype(jnp.float32))
        gg = getattr(got, name).numpy()
        assert gg.shape == gw.shape, name
        rel = np.abs(gg - gw).max() / (np.abs(gw).max() + 1e-3)
        assert rel < 1e-2, (name, rel)


def test_fused_apply_backward_on_cpu_runs_the_plain_version(full_width):
    _, model = full_width
    pts, views = (torch.from_numpy(a) for a in _inputs(9, 50))
    before = tfm.fused_mlp_bwd.launches
    model.zero_grad(set_to_none=True)
    tfm.fused_apply(model, pts, views).square().sum().backward()
    assert model.trunk[0].weight.grad is not None
    assert tfm.fused_mlp_bwd.launches == before
    model.zero_grad(set_to_none=True)


def test_fused_mlp_bwd_refuses_host_tensors(full_width):
    _, model = full_width
    wk, wkt = tfm.backward_weights(model, False, tfm.forward_weights(model, raw=False))
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_bwd(wk, wkt, torch.zeros(8, 64), torch.zeros(8, 32), torch.zeros(8, 8))


@pytest.mark.parametrize("n_freqs,out_cols", [(10, 64), (4, 32)])
def test_encode_tile_matches_jax(n_freqs, out_cols):
    pts = np.random.default_rng(n_freqs).uniform(-4, 4, (200, 8)).astype(np.float32)
    want = np.asarray(jfm._encode_tile(jnp.asarray(pts), n_freqs, out_cols))
    got = tfm._encode_tile(torch.from_numpy(pts), n_freqs, out_cols).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert tfm._block_perm(n_freqs) == jfm._block_perm(n_freqs)


@pytest.mark.parametrize("raw_layout", [False, True])
def test_pack_params_layouts_match_jax(full_width, raw_layout):
    tree, model = full_width
    want = jfm.pack_params(tree, raw_layout=raw_layout)
    got = tfm.pack_params(model, raw_layout=raw_layout)
    for name in jfm.FusedMLPWeights._fields:
        np.testing.assert_array_equal(
            getattr(got, name).float().numpy(),
            np.asarray(getattr(want, name).astype(jnp.float32)), err_msg=name)


@pytest.mark.parametrize("raw_layout", [False, True])
def test_unpack_grads_round_trip_and_matches_jax(full_width, raw_layout):
    """unpack_grads inverts pack_params' layout (float32 packing, so the
    round trip is exact) and maps a padded gradient as the reference's
    unpack_grads does."""
    tree, model = full_width
    packed = tfm.pack_params(model, dtype=torch.float32, raw_layout=raw_layout)
    back = tfm.unpack_grads(packed, model, raw_layout=raw_layout)
    for name, p in model.named_parameters():
        torch.testing.assert_close(back[name], p.detach(), rtol=0, atol=0)

    rng = np.random.default_rng(10)
    g = jfm.FusedMLPWeights(*(rng.standard_normal(a.shape).astype(np.float32)
                              for a in jfm.pack_params(tree)))
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jfm.unpack_grads(jax.tree_util.tree_map(jnp.asarray, g), tree, raw_layout=raw_layout)))
    got = tfm.unpack_grads(tfm.FusedMLPWeights(*(torch.from_numpy(a) for a in g)), model,
                           raw_layout=raw_layout)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


def test_kernel_weights_raw_and_bwd_layouts(full_width):
    """The raw-layout staging buffer is pack_params(raw_layout=True)
    transposed, piece by piece; the dX staging buffer holds the dX
    products' matrices as [in][out]; the gradient buffer's size matches
    GRAD_ELEMS of the CUDA source."""
    _, model = full_width
    W = tfm.pack_params(model, dtype=torch.float64, raw_layout=True)
    wk = tfm._build_kernel_weights(model, raw_layout=True)
    at = 0
    for name, rows, cols in tfm.KERNEL_LAYOUT:
        piece = wk[at: at + rows * cols].reshape(rows, cols)
        field = getattr(W, name)
        want = field[:, :cols] if name.startswith("b") else field.T[:rows]
        torch.testing.assert_close(piece, want, rtol=0, atol=0)
        at += rows * cols
    assert at == wk.numel()
    assert not torch.equal(tfm._build_kernel_weights(model, raw_layout=False), wk)

    Wp = tfm.pack_params(model, dtype=torch.float64)
    wkt = tfm._build_kernel_weights_bwd(model)
    fields = {"wv": Wp.wv[:256], "wb": Wp.wb, "w5": Wp.w5[64:320],
              **{f"w{i}": getattr(Wp, f"w{i}") for i in (1, 2, 3, 4, 6, 7)}}
    at = 0
    for name, rows, cols in tfm.KERNEL_LAYOUT_BWD:
        piece = wkt[at: at + rows * cols].reshape(rows, cols)
        torch.testing.assert_close(piece, fields[name], rtol=0, atol=0)
        at += rows * cols
    assert at == wkt.numel()
    assert _cuda_constants()["GRAD_ELEMS"] == tfm.GRAD_ELEMS == 645_760


def test_build_hash_tracks_included_headers(tmp_path):
    """A library's name hashes its source and every header it includes,
    so an edit to a shared header rebuilds each library that uses it."""
    from nerf_projects_tpu_torch.ops.kernels import _build

    (tmp_path / "a.cu").write_text('#include "tile.cuh"\n#include <cuda_runtime.h>\nint a;\n')
    (tmp_path / "tile.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    assert [p.name for p in _build.sources("a", tmp_path)] == ["a.cu", "tile.cuh", "inner.cuh"]
    before = _build.digest("a", tmp_path)
    (tmp_path / "inner.cuh").write_text("// v2\n")
    assert _build.digest("a", tmp_path) != before
    for name in ("fused_mlp_fwd", "fused_mlp_bwd", "fused_train"):
        assert "mlp_tile.cuh" in [p.name for p in _build.sources(name)]


@pytest.mark.parametrize("name", ["fused_mlp_fwd", "fused_train", "fused_mlp_raw_fwd", "fused_mlp_raw_bwd",
                                  "fused_mlp_bwd", "fused_sh_fwd", "fused_sh_bwd"])
def test_wgmma_kernels_build_over_the_core(name):
    """K1f, K2, K1rf, K1rb, K1b, K5f and K5b include the wgmma core over
    the shared layouts, so an edit to either rebuilds them."""
    from nerf_projects_tpu_torch.ops.kernels import _build

    assert [p.name for p in _build.sources(name)] == [f"{name}.cu", "mlp_sm90.cuh", "mlp_tile.cuh"]


def test_no_kernel_builds_on_the_warp_level_tile():
    """Every MLP kernel runs on the wgmma core: no source under csrc/
    issues the warp-level mma.sync product or includes the tile header it
    lived in."""
    from nerf_projects_tpu_torch.ops.kernels import _build

    csrc = Path(tfm.__file__).resolve().parents[2] / "csrc"
    assert not (csrc / "fused_sh_tile.cuh").exists()
    for path in csrc.iterdir():
        assert "mma.sync" not in path.read_text(), path.name
    for name in ("fused_sh_fwd", "fused_sh_bwd"):
        assert "fused_sh_tile.cuh" not in [p.name for p in _build.sources(name)]


# ---------------------------------------------------------------------------
# The wgmma core's weight buffers (csrc/mlp_sm90.cuh)
# ---------------------------------------------------------------------------

def _sm90_constants():
    """The ``constexpr long long`` constants of csrc/mlp_sm90.cuh, over
    mlp_tile.cuh's namespace mlp."""
    src = (Path(tfm.__file__).resolve().parents[2] / "csrc" / "mlp_sm90.cuh").read_text()
    env = dict(_cuda_constants())
    for name, expr in re.findall(r"constexpr long long (\w+) = ([^;]+);", src):
        env[name] = eval(expr, {}, dict(env))
    return env


def _layout_offsets(layout):
    offsets, at = {}, 0
    for name, n, k, _ in layout:
        offsets[name] = at
        at += n * k
    return offsets, at


def _unslab(buf, at, n, k, kd):
    """The inverse of ``sm90_slabs``: [n, k] from the passes and slabs at
    ``at``."""
    npass = min(n, tfm.SM90_PASS)
    rows = []
    for _ in range(0, n, npass):
        parts = []
        for k0 in range(0, k, kd):
            d = min(kd, k - k0)
            parts.append(buf[at: at + npass * d].view(d // 8, npass // 8, 8, 8).permute(1, 2, 0, 3).reshape(npass, d))
            at += npass * d
        rows.append(torch.cat(parts, dim=1))
    return torch.cat(rows, dim=0)


def test_sm90_layout_matches_cuda_source():
    """SM90_LAYOUT's, SM90_BIASES' and SM90_LAYOUT_BWD's offsets are the
    SW_* and SWT_* constants of the CUDA source."""
    env = _sm90_constants()
    offsets, at = _layout_offsets(tfm.SM90_LAYOUT)
    for name in ("w0", "w1", "w5", "w6", "wsig", "wb", "wv", "wrgb"):
        assert env[f"SW_{name.upper()}"] == offsets[name], name
    assert env["SW_B"] == at
    for name, n in tfm.SM90_BIASES:
        if name in ("bb", "bv", "bsig", "brgb"):
            assert env[f"SW_{name.upper()}"] == at, name
        at += n
    assert env["SW_WEIGHTS"] == at
    offsets, at = _layout_offsets(tfm.SM90_LAYOUT_BWD)
    for name in ("wrgb", "wv", "wb", "w7"):
        assert env[f"SWT_{name.upper()}"] == offsets[name], name
    assert env["SWT_WEIGHTS"] == at
    src = (Path(tfm.__file__).resolve().parents[2] / "csrc" / "mlp_sm90.cuh").read_text()
    assert int(re.search(r"constexpr int NP_MAX = (\d+);", src).group(1)) == tfm.SM90_PASS


@pytest.mark.parametrize("raw_layout", [False, True])
def test_sm90_weights_hold_each_entry_of_kernel_weights_once(raw_layout):
    """Built over a model whose parameters hold their own positions, the
    wgmma core's buffer holds every entry of kernel_weights' buffer once
    and nothing else (the rest is padding)."""
    probe = NeRFMLP(depth=8, width=256, use_viewdirs=True).double()
    with torch.no_grad():
        at = 1
        for p in probe.parameters():
            p.copy_(torch.arange(at, at + p.numel(), dtype=torch.float64).view(p.shape))
            at += p.numel()
    old = tfm._build_kernel_weights(probe, raw_layout)
    new = tfm._build_kernel_weights_sm90(probe, raw_layout)
    assert new.numel() == _sm90_constants()["SW_WEIGHTS"]
    torch.testing.assert_close(torch.sort(new[new != 0]).values, torch.sort(old[old != 0]).values, rtol=0, atol=0)
    assert torch.unique(new[new != 0]).numel() == int((new != 0).sum())


@pytest.mark.parametrize("raw_layout", [False, True])
def test_sm90_weights_unpack_to_the_linear_weights(full_width, raw_layout):
    """Unslabbed, each matrix of kernel_weights_sm90 is the model's
    nn.Linear weight ([out][in]; the encoded-input rows permuted to the
    block layout with raw_layout), zero-padded; then the biases."""
    _, model = full_width
    wk = tfm.kernel_weights_sm90(model, raw_layout=raw_layout).float()
    t = model.trunk
    pp = tfm._block_perm(10) if raw_layout else list(range(63))
    pv = tfm._block_perm(4) if raw_layout else list(range(27))
    bf = lambda a: a.detach().to(torch.bfloat16).float()  # noqa: E731
    want = {f"w{i}": bf(t[i].weight) for i in (1, 2, 3, 4, 6, 7)}
    want["w0"] = torch.nn.functional.pad(bf(t[0].weight)[:, pp], (0, 1))
    want["w5"] = torch.cat([torch.nn.functional.pad(bf(t[5].weight)[:, :63][:, pp], (0, 1)), bf(t[5].weight)[:, 63:]], 1)
    want["wsig"] = torch.nn.functional.pad(bf(model.sigma_head.weight), (0, 0, 0, 7))
    want["wb"] = bf(model.bottleneck.weight)
    want["wv"] = torch.cat([bf(model.view_0.weight)[:, :256],
                            torch.nn.functional.pad(bf(model.view_0.weight)[:, 256:][:, pv], (0, 5))], 1)
    want["wrgb"] = torch.nn.functional.pad(bf(model.rgb_head.weight), (0, 0, 0, 5))
    offsets, at = _layout_offsets(tfm.SM90_LAYOUT)
    for name, n, k, kd in tfm.SM90_LAYOUT:
        torch.testing.assert_close(_unslab(wk, offsets[name], n, k, kd), want[name], rtol=0, atol=0, msg=name)
    biases = [bf(t[i].bias) for i in range(8)] + [bf(model.bottleneck.bias), bf(model.view_0.bias)]
    biases += [torch.nn.functional.pad(bf(model.sigma_head.bias), (0, 7)), torch.nn.functional.pad(bf(model.rgb_head.bias), (0, 5))]
    torch.testing.assert_close(wk[at:], torch.cat(biases), rtol=0, atol=0)


def test_sm90_bwd_weights_unpack_to_the_linear_weights(full_width):
    """Unslabbed, each matrix of kernel_weights_sm90_bwd is the transpose
    of the nn.Linear weight its dX product takes: the rgb head, view_0's
    bottleneck columns, [bottleneck | sigma head], trunk_7..5 (h columns),
    trunk_4..1."""
    _, model = full_width
    wkt = tfm.kernel_weights_sm90_bwd(model).float()
    t = model.trunk
    bfT = lambda a: a.detach().to(torch.bfloat16).float().T  # noqa: E731
    want = {f"w{i}": bfT(t[i].weight) for i in (1, 2, 3, 4, 6, 7)}
    want["w5"] = bfT(t[5].weight[:, 63:])
    want["wrgb"] = torch.nn.functional.pad(bfT(model.rgb_head.weight), (0, 13))
    want["wv"] = bfT(model.view_0.weight[:, :256])
    want["wb"] = torch.cat([bfT(model.bottleneck.weight), torch.nn.functional.pad(bfT(model.sigma_head.weight), (0, 15))], 1)
    offsets, at = _layout_offsets(tfm.SM90_LAYOUT_BWD)
    for name, n, k, kd in tfm.SM90_LAYOUT_BWD:
        torch.testing.assert_close(_unslab(wkt, offsets[name], n, k, kd), want[name], rtol=0, atol=0, msg=name)
    assert at == wkt.numel()


# (C interface, entry, constant of csrc/mlp_sm90.cuh or mlp_tile.cuh, the
# buffer the route hands it: forward, dX or gradients)
_SM90_ENTRIES = [
    ("fused_mlp_fwd", "weight_elems", "SW_WEIGHTS", "encoded forward"),
    ("fused_mlp_bwd", "weight_elems", "SW_WEIGHTS", "encoded backward"),
    ("fused_mlp_bwd", "weight_t_elems", "SWT_WEIGHTS", "encoded dX"),
    ("fused_mlp_bwd", "grad_elems", "GRAD_ELEMS", "gradients"),
    ("fused_mlp_raw_fwd", "weight_elems", "SW_WEIGHTS", "raw forward"),
    ("fused_mlp_raw_bwd", "weight_elems", "SW_WEIGHTS", "raw backward"),
    ("fused_mlp_raw_bwd", "weight_t_elems", "SWT_WEIGHTS", "raw dX"),
    ("fused_mlp_raw_bwd", "grad_elems", "GRAD_ELEMS", "gradients"),
]


@pytest.mark.parametrize("lib, entry, const, buffer", _SM90_ENTRIES)
def test_wgmma_kernels_report_the_sm90_buffer_sizes(full_width, lib, entry, const, buffer):
    """K1f's, K1b's, K1rf's and K1rb's C interfaces report the wgmma core's
    buffer sizes, and those are the sizes of the buffers the routes hand
    them (forward_weights / backward_weights)."""
    _, model = full_width
    src = (Path(tfm.__file__).resolve().parents[2] / "csrc" / f"{lib}.cu").read_text()
    ret = re.search(rf"long long {lib}_{entry}\(\) {{ return ([\w:]+); }}", src).group(1)
    assert ret.split("::")[-1] == const
    enc = tfm.forward_weights(model, raw=False)
    raw = tfm.forward_weights(model, raw=True)
    raw_bwd = tfm.backward_weights(model, True, raw)
    enc_bwd = tfm.backward_weights(model, False, enc)
    numel = {"encoded forward": enc.numel(), "raw forward": raw.numel(), "raw backward": raw_bwd[0].numel(),
             "raw dX": raw_bwd[1].numel(), "encoded backward": enc_bwd[0].numel(),
             "encoded dX": enc_bwd[1].numel(), "gradients": tfm.GRAD_ELEMS}[buffer]
    assert _sm90_constants()[const] == numel


def test_raw_route_draws_both_kernels_from_one_gather(full_width, monkeypatch):
    """The raw route gathers K1rf's raw-layout buffer once; K1rb's
    backward reuses it and gathers only the dX buffer."""
    _, model = full_width
    calls, real = [], tfm.gather_weights
    monkeypatch.setattr(tfm, "gather_weights", lambda m, layout, build: calls.append(layout) or real(m, layout, build))
    wk = tfm.forward_weights(model, raw=True)
    fwd, wkt = tfm.backward_weights(model, True, wk)
    assert fwd is wk
    assert calls == [("fused_mlp_sm90", True), ("fused_mlp_sm90_bwd",)]
    monkeypatch.undo()
    torch.testing.assert_close(wk, tfm.kernel_weights_sm90(model, raw_layout=True), rtol=0, atol=0)
    torch.testing.assert_close(wkt, tfm.kernel_weights_sm90_bwd(model), rtol=0, atol=0)


def test_encoded_route_hands_k1f_the_model_layout(full_width):
    """The encoded route's K1f takes the wgmma core's buffer in the
    model's layout; K1b takes the same buffer and the dX buffer."""
    _, model = full_width
    wk = tfm.forward_weights(model, raw=False)
    torch.testing.assert_close(wk, tfm.kernel_weights_sm90(model), rtol=0, atol=0)
    assert not torch.equal(wk, tfm.kernel_weights_sm90(model, raw_layout=True))
    fwd, wkt = tfm.backward_weights(model, False, wk)
    assert fwd is wk
    torch.testing.assert_close(wkt, tfm.kernel_weights_sm90_bwd(model), rtol=0, atol=0)


def test_encoded_route_draws_both_kernels_from_one_gather(full_width, monkeypatch):
    """The encoded route gathers K1f's buffer once; K1b's backward reuses
    it and gathers only the dX buffer (no second forward gather)."""
    _, model = full_width
    calls, real = [], tfm.gather_weights
    monkeypatch.setattr(tfm, "gather_weights", lambda m, layout, build: calls.append(layout) or real(m, layout, build))
    wk = tfm.forward_weights(model, raw=False)
    assert tfm.backward_weights(model, False, wk)[0] is wk
    assert calls == [("fused_mlp_sm90", False), ("fused_mlp_sm90_bwd",)]
