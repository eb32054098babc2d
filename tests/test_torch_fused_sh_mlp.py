"""The port's fused NeRF-SH trunk (K5, ``ops/kernels/fused_sh_mlp.py``)
against the JAX package's ``fused_sh_apply`` (CPU).

On the CPU the port runs the plain PyTorch versions of K5f and K5b; the
JAX side runs its Pallas kernels in interpret mode, as
tests/test_fused_sh_mlp.py does. Both round to bf16 at the same points
and sum float32 in other orders. Every bias is drawn from a seeded normal
(flax zeroes them), so a misplaced bias shows. The CUDA kernels are held
against the plain versions on the card by chip_smoke.py.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_projects_tpu.ops.pallas.fused_sh_mlp as jfsm
import nerf_projects_tpu_torch.ops.kernels.fused_mlp as fm
import nerf_projects_tpu_torch.ops.kernels.fused_sh_mlp as tfsm
from nerf_projects_tpu.models.nerf_sh import CondMLP as FlaxCondMLP
from nerf_projects_tpu_torch.models.nerf_sh import CondMLP, cond_mlp_flax_to_state_dict
from tests.test_torch_fused_mlp import random_biases
from tests.test_torch_fused_train import assert_grads_close

# The forward against JAX's, of scale (the largest |entry|): both round
# the same operands to bf16 and sum float32 in other orders. Where a sum
# sits on a bf16 rounding boundary the two round it apart, and that row's
# later layers carry bf16-level noise: on these inputs JAX's kernel itself
# strays up to 2.1e-3 from float64 sums of the same products, and the
# plain version up to 2.7e-3 from JAX's (4 entries of 15,903 beyond 2e-3).
# So every entry is held within FWD_MAX_TOL and all but 0.1% (or one)
# within FWD_TOL; the relative Frobenius error, which those few rows move little
# (at most 2.8e-4 here), is held within FWD_FRO_TOL, and a product that
# misses one rounding point moves every row (1.3e-3 to 5e-3,
# test_rules_catch_a_missing_rounding_point).
FWD_TOL = 2e-3
FWD_MAX_TOL = 5e-3
FWD_FRO_TOL = 6e-4
HEADS = {"sh_deg 2": 27, "sh_deg 3": 48, "sg_dim 4": 12}
N = jfsm.TILE + 77  # a ragged tail on the JAX side


# Gradients end to end (jax.grad through the custom VJP against autograd):
# relative Frobenius error and worst entry (of the tensor's largest
# |entry|), chip_smoke.py's GRAD_FRO_TOL and GRAD_MAX_TOL. Each side
# recomputes the forward, and a row that rounds apart there flips relu
# masks, which moves whole columns of dW: on these inputs the plain K5b
# strays up to 7e-3 (Frobenius) and 3.3e-2 (worst entry) from JAX's, with
# up to 3.9% of a bias's entries beyond 5e-3, so assert_grads_close's
# entrywise count cannot hold. The backward's own rounding points are held
# apart from that noise: with the recompute taken from JAX's, the plain
# K5b meets assert_grads_close and BWD_FRO_TOL (at most 5.7e-4 here),
# which a product that misses one rounding point exceeds (1.8e-3 to
# 5.3e-3).
GRAD_FRO_TOL = 2e-2
GRAD_MAX_TOL = 5e-2
BWD_FRO_TOL = 1e-3


def assert_grads_near(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    fro = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)
    worst = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert fro < GRAD_FRO_TOL and worst < GRAD_MAX_TOL, (name, float(fro), float(worst))


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


def _mlp_pair(seed, num_rgb):
    """The flax CondMLP's params (random biases), the port's CondMLP
    holding them, and num_rgb."""
    params = jax.jit(FlaxCondMLP(num_rgb_channels=num_rgb).init)(jax.random.PRNGKey(seed), jnp.zeros((1, 63)))
    tree = random_biases(jax.tree_util.tree_map(np.asarray, params), seed)
    port = CondMLP(num_rgb_channels=num_rgb)
    port.load_state_dict(cond_mlp_flax_to_state_dict(tree), strict=True)
    return tree, port, num_rgb


@pytest.fixture(scope="module")
def mlps():
    """Per head: ``_mlp_pair``."""
    return {name: _mlp_pair(seed, num_rgb) for seed, (name, num_rgb) in enumerate(HEADS.items())}


def _inputs(seed, num_rgb):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, 63)).astype(np.float32)
    cot_rgb = rng.standard_normal((N, num_rgb)).astype(np.float32)
    cot_sig = rng.standard_normal((N, 1)).astype(np.float32)
    return x, cot_rgb, cot_sig


def _assert_scaled(got, want, tol, name):
    """Within tol of the largest |want| everywhere."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    d = np.abs(got - want) / np.abs(want).max()
    assert d.max() < tol, (name, float(d.max()))


def assert_forward_near(got, want, name):
    """The forward rule: every entry within FWD_MAX_TOL of scale, all but
    0.1% (or one, in a small tensor) within FWD_TOL, relative Frobenius
    error within FWD_FRO_TOL."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    d = np.abs(got - want) / np.abs(want).max()
    fro = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert d.max() < FWD_MAX_TOL and (d > FWD_TOL).sum() <= max(1, 1e-3 * d.size) and fro < FWD_FRO_TOL, (
        name, float(d.max()), int((d > FWD_TOL).sum()), float(fro))


@pytest.fixture(scope="module")
def jax_forward(mlps):
    """Per head: JAX's fused_sh_apply on the forward test's inputs."""
    out = {}
    for head, (tree, _, num_rgb) in mlps.items():
        x, _, _ = _inputs(1, num_rgb)
        old = jfsm.INTERPRET
        jfsm.INTERPRET = True
        try:
            out[head] = [np.asarray(a) for a in jfsm.fused_sh_apply(tree["params"], jnp.asarray(x), num_rgb)]
        finally:
            jfsm.INTERPRET = old
    return out


def _plain_forward(mlps, head):
    _, port, num_rgb = mlps[head]
    x, _, _ = _inputs(1, num_rgb)
    with torch.no_grad():
        return tfsm.fused_sh_apply(port, torch.from_numpy(x), num_rgb)


@pytest.mark.parametrize("head", list(HEADS))
def test_plain_forward_matches_jax(mlps, jax_forward, head):
    _, port, num_rgb = mlps[head]
    want_rgb, want_sig = jax_forward[head]
    got_rgb, got_sig = _plain_forward(mlps, head)
    assert_forward_near(got_rgb, want_rgb, "rgb")
    assert_forward_near(got_sig, want_sig, "sigma")
    # and the float32 modules are near: bf16 products, not another function
    x, _, _ = _inputs(1, num_rgb)
    with torch.no_grad():
        f32_rgb, f32_sig = port(torch.from_numpy(x))
    _assert_scaled(got_rgb, f32_rgb, 5e-2, "rgb vs float32")


@pytest.mark.parametrize("head", list(HEADS))
def test_weight_grads_match_jax(mlps, head):
    """jax.grad through the reference's custom VJP (K5b in interpret mode)
    against autograd through the port's Function (the plain K5b)."""
    tree, port, num_rgb = mlps[head]
    x, cot_rgb, cot_sig = _inputs(2, num_rgb)

    def loss(p):
        r, s = jfsm.fused_sh_apply(p, jnp.asarray(x), num_rgb)
        return jnp.sum(r * cot_rgb) + jnp.sum(s * cot_sig)

    want = jax.grad(loss)(tree["params"])
    port.zero_grad(set_to_none=True)
    r, s = tfsm.fused_sh_apply(port, torch.from_numpy(x), num_rgb)
    (torch.sum(r * torch.from_numpy(cot_rgb)) + torch.sum(s * torch.from_numpy(cot_sig))).backward()
    for i, layer in enumerate(port.dense):
        assert_grads_near(layer.weight.grad.T.numpy(), want[f"Dense_{i}"]["kernel"], f"Dense_{i} kernel")
        assert_grads_near(layer.bias.grad.numpy(), want[f"Dense_{i}"]["bias"], f"Dense_{i} bias")


def _jax_backward(tree, num_rgb):
    """On the backward test's inputs: JAX's _fused_sh_bwd on the padded
    weights and rows, and the activations of its recompute, which is
    _fwd_tile run tile by tile (its outputs are the kernel's bit for bit)."""
    tile = jax.jit(jfsm._fwd_tile)
    x, cot_rgb, cot_sig = _inputs(3, num_rgb)
    n_pad = 2 * jfsm.TILE
    xp = np.zeros((n_pad, 64), np.float32)
    xp[:N, :63] = x
    g_rgb = np.zeros((n_pad, 128), np.float32)
    g_rgb[:N, :num_rgb] = cot_rgb
    g_sig = np.zeros((n_pad, 8), np.float32)
    g_sig[:N, :1] = cot_sig
    W = jfsm.pack_sh_params(tree["params"])
    old = jfsm.INTERPRET
    jfsm.INTERPRET = True
    try:
        rgb, sig = jfsm._fused_sh_impl(W, jnp.asarray(xp))
        want, _ = jfsm._fused_sh_bwd((W, jnp.asarray(xp)), (jnp.asarray(g_rgb), jnp.asarray(g_sig)))
    finally:
        jfsm.INTERPRET = old
    tiles = [tile(jnp.asarray(xp[i: i + jfsm.TILE]), W) for i in range(0, n_pad, jfsm.TILE)]
    np.testing.assert_array_equal(np.concatenate([np.asarray(t[0]) for t in tiles]), np.asarray(rgb))
    np.testing.assert_array_equal(np.concatenate([np.asarray(t[1])[:, :8] for t in tiles]), np.asarray(sig))
    acts = {k: torch.from_numpy(np.concatenate([np.asarray(t[2][k]) for t in tiles])[:N]) for k in tiles[0][2]}
    return {f: np.asarray(getattr(want, f)) for f in jfsm.FusedSHWeights._fields}, acts


@pytest.fixture(scope="module")
def jax_backward(mlps):
    """Per head: ``_jax_backward``."""
    return {head: _jax_backward(tree, num_rgb) for head, (tree, _, num_rgb) in mlps.items()}


@pytest.fixture(scope="module")
def wide():
    """The widest coefficient head the kernels take (MAX_RGB columns):
    ``_mlp_pair`` and ``_jax_backward``."""
    pair = _mlp_pair(len(HEADS), tfsm.MAX_RGB)
    return pair, _jax_backward(pair[0], tfsm.MAX_RGB)


def _plain_backward(mlps, jax_backward, head):
    """The plain K5b's padded gradients on the backward test's inputs, its
    forward recompute replaced by JAX's activations."""
    _, port, num_rgb = mlps[head]
    x, cot_rgb, cot_sig = _inputs(3, num_rgb)
    acts = jax_backward[head][1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfsm, "_fwd_tile", lambda W, xp: (None, None, acts))
        return tfsm.fused_sh_bwd_reference(tfsm.pack_sh_params(port), torch.from_numpy(x),
                                           torch.from_numpy(cot_rgb), torch.from_numpy(cot_sig))


def assert_backward_near(got, want):
    """The backward rule, field by field: assert_grads_close and a relative
    Frobenius error within BWD_FRO_TOL."""
    for name in tfsm.FusedSHWeights._fields:
        g, w = getattr(got, name).numpy(), want[name]
        assert_grads_close(g, w, name)
        fro = np.linalg.norm(g.astype(np.float64) - w) / (np.linalg.norm(w.astype(np.float64)) + 1e-30)
        assert fro < BWD_FRO_TOL, (name, float(fro))


@pytest.mark.parametrize("head", list(HEADS))
def test_backward_reference_matches_jax_padded_grads(mlps, jax_backward, head):
    """The plain K5b's padded gradients, field by field, against the
    reference's _fused_sh_bwd on the same padded weights, both sides on
    JAX's recomputed activations."""
    assert_backward_near(_plain_backward(mlps, jax_backward, head), jax_backward[head][0])


ORIGINAL_MM = fm._mm


def _mm_unrounded_at(at):
    """fused_mlp._mm with its bf16 rounding left out at the ``at``-th call
    of one forward (5: dense 5, 9: the coefficient head)."""
    calls = [0]

    def mm(a, w):
        i, calls[0] = calls[0], calls[0] + 1
        return a.float() @ w.float() if i == at else ORIGINAL_MM(a, w)

    return mm


# a fused_mlp product with one bf16 rounding left out: (its name, a maker)
MISSING_ROUNDING = {
    "dense 5's input": ("_mm", lambda: _mm_unrounded_at(5)),
    "the coefficient head's input": ("_mm", lambda: _mm_unrounded_at(9)),
    "g in the dX products": ("_mmBT", lambda: lambda g, w: g.float() @ w.float().T),
    "activations in dW": ("_mmT", lambda: lambda a, b: a.float().T @ b.to(torch.bfloat16).float()),
    "g in dW": ("_mmT", lambda: lambda a, b: a.to(torch.bfloat16).float().T @ b.float()),
}


@pytest.mark.parametrize("fault", list(MISSING_ROUNDING))
def test_rules_catch_a_missing_rounding_point(mlps, jax_forward, jax_backward, fault):
    """A plain version that leaves out one bf16 rounding fails the rule
    that holds the right one (sh_deg 3)."""
    attr, make = MISSING_ROUNDING[fault]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fm, attr, make())
        with pytest.raises(AssertionError):
            if attr == "_mm":
                want_rgb, want_sig = jax_forward["sh_deg 3"]
                got_rgb, got_sig = _plain_forward(mlps, "sh_deg 3")
                assert_forward_near(got_rgb, want_rgb, "rgb")
                assert_forward_near(got_sig, want_sig, "sigma")
            else:
                assert_backward_near(_plain_backward(mlps, jax_backward, "sh_deg 3"), jax_backward["sh_deg 3"][0])


def test_pack_sh_params_matches_jax(mlps):
    tree, port, _ = mlps["sh_deg 3"]
    want = jfsm.pack_sh_params(tree["params"])
    got = tfsm.pack_sh_params(port)
    for name in tfsm.FusedSHWeights._fields:
        np.testing.assert_array_equal(getattr(got, name).float().numpy(),
                                      np.asarray(getattr(want, name).astype(jnp.float32)), err_msg=name)


def test_w5_permutation_round_trip(mlps):
    """The staging buffer the kernels' weights are built from holds dense
    5's input columns as [x | h]; the kernel's gradient of w5, in that row
    order, un-permutes to the reference's [h | x] rows
    (split_kernel_grads), and the padded gradients map back onto the
    parameters (unpack_sh_grads)."""
    _, port, num_rgb = mlps["sh_deg 3"]
    w5 = port.dense[5].weight.detach()
    wk = tfsm._build_kernel_weights(port)
    at = {}
    total = 0
    for name, rows, cols in tfsm.KERNEL_LAYOUT:
        at[name] = (total, rows, cols)
        total += rows * cols
    assert wk.numel() == total
    o, r, c = at["w5"]
    block = wk[o: o + r * c].view(r, c)
    torch.testing.assert_close(block[:, :63], w5[:, 256:].double(), rtol=0, atol=0)
    assert not block[:, 63].any()
    torch.testing.assert_close(block[:, 64:], w5[:, :256].double(), rtol=0, atol=0)

    # the kernel's layout of the gradient buffer: FusedSHWeights' padded
    # shapes with w5's rows in the kernels' order; fill w5 with the staging
    # buffer's own block ([in][out]) and every other field with its pack
    packed = tfsm.pack_sh_params(port, dtype=torch.float32)
    flat = torch.cat([block.float().T.reshape(-1) if name == "w5" else getattr(packed, name).reshape(-1)
                      for name in tfsm.FusedSHWeights._fields])
    assert flat.numel() == tfsm.GRAD_ELEMS
    split = tfsm.split_kernel_grads(flat)
    torch.testing.assert_close(split.w5, packed.w5, rtol=0, atol=0)
    named = tfsm.unpack_sh_grads(packed, port)
    for name, p in port.named_parameters():
        torch.testing.assert_close(named[name], p.detach(), rtol=0, atol=0)


def _csrc(name):
    return (Path(tfsm.__file__).resolve().parents[2] / "csrc" / name).read_text()


def _sh_constants():
    """The ``constexpr`` integer constants of csrc/mlp_tile.cuh's namespace
    sh; ``mlp::X`` reads namespace mlp's X."""
    src = _csrc("mlp_tile.cuh")

    def parse(ns, env):
        body = re.search(rf"\nnamespace {ns} {{\n(.*?)\n}}  // namespace {ns}\n", src, re.S).group(1)
        for k, expr in re.findall(r"(?m)^constexpr (?:long long|int) (\w+) = ([^;]+);", body.replace("mlp::", "mlp_")):
            env[k] = eval(expr, {}, dict(env))
        return env

    return parse("sh", {f"mlp_{k}": v for k, v in parse("mlp", {}).items()})


def _probe(num_rgb):
    """A float64 CondMLP whose parameters hold their own positions 1, 2, ..."""
    probe = _port_mlp(num_rgb, 0).double()
    with torch.no_grad():
        at = 1
        for prm in probe.parameters():
            prm.copy_(torch.arange(at, at + prm.numel(), dtype=torch.float64).view(prm.shape))
            at += prm.numel()
    return probe


def test_kernel_layouts_match_cuda_source():
    """GRAD_SHAPES is the gradient layout sh::GW* of csrc/mlp_tile.cuh and
    STASH_BYTES_PER_ROW its stash features; SM90_LAYOUT_BWD's offsets are
    mlp_sm90.cuh's SWT_SH_* and its layers SH_DX_LAYERS, the dX ring's
    table; the dX buffer holds each weight its products take once (the
    coefficient head's, the sigma head's, w7..w1 with w5's h rows) and
    nothing else."""
    from tests.test_torch_fused_mlp import _cuda_layers, _layout_offsets, _sm90_constants

    env = _sh_constants()
    at, offsets = 0, {}
    for name, (r, c) in zip(tfsm.FusedSHWeights._fields, tfsm.GRAD_SHAPES):
        offsets[name] = at
        at += r * c
    for name in ("w0", "w1", "w5", "w6", "wsig", "wrgb", "b0", "bsig", "brgb"):
        key = ("GB" + name[1:] if name.startswith("b") else "GW" + name[1:]).upper()
        assert env[key] == offsets[name], name
    assert env["GRAD_ELEMS"] == tfsm.GRAD_ELEMS == at
    assert env["MAX_RGB"] == tfsm.MAX_RGB and env["G_SIG"] == env["G_RGB"] + tfsm.MAX_RGB
    assert 2 * (env["A_FEATS"] + env["G_FEATS"]) == tfsm.STASH_BYTES_PER_ROW

    sm = _sm90_constants()
    offsets, total = _layout_offsets(tfsm.SM90_LAYOUT_BWD)
    assert sm["SWT_SH_HEADS"] == offsets["wh"] and sm["SWT_SH_W7"] == offsets["w7"]
    assert sm["SWT_SH_WEIGHTS"] == total
    assert [(n, k, kd) for _, n, k, kd in tfsm.SM90_LAYOUT_BWD] == _cuda_layers("SH_DX_LAYERS")
    assert tfsm.SM90_LAYOUT_BWD[0][2] == tfsm.MAX_RGB + 16

    probe = _probe(27)
    d = probe.dense
    wkt = tfsm._build_kernel_weights_sm90_bwd(probe)
    assert wkt.numel() == total
    live = wkt[wkt != 0]
    assert torch.unique(live).numel() == live.numel()
    want = torch.cat([d[i].weight.reshape(-1) for i in (1, 2, 3, 4, 6, 7, 8, 9)] + [d[5].weight[:, :256].reshape(-1)])
    torch.testing.assert_close(torch.sort(live).values, torch.sort(want.detach()).values, rtol=0, atol=0)


def _sm90_bwd_matrices(wkt):
    """K5b's dX buffer -> its [N][K] matrices by name (fused_mlp.sm90_slabs
    undone)."""
    from tests.test_torch_fused_mlp import _unslab

    mats, at = {}, 0
    for name, n, k, kd in tfsm.SM90_LAYOUT_BWD:
        mats[name] = _unslab(wkt, at, n, k, kd)
        at += n * k
    assert at == wkt.numel()
    return mats


def test_kernel_weights_bwd_holds_the_transposed_weights(mlps):
    """Unslabbed, each matrix of kernel_weights_sm90_bwd is the transpose of
    the nn.Linear weights its dX product takes: [coefficient head^T (num_rgb
    of 128 columns) | sigma head^T (1 of 16)], then w7, w6, w5's h columns,
    w4..w1."""
    _, port, num_rgb = mlps["sg_dim 4"]
    mats = _sm90_bwd_matrices(tfsm.kernel_weights_sm90_bwd(port).float())
    d = port.dense
    bfT = lambda a: a.detach().bfloat16().float().T  # noqa: E731
    want = {f"w{i}": bfT(d[i].weight) for i in (1, 2, 3, 4, 6, 7)}
    want["w5"] = bfT(d[5].weight[:, :256])
    want["wh"] = torch.zeros(256, tfsm.MAX_RGB + 16)
    want["wh"][:, :num_rgb] = bfT(d[9].weight)
    want["wh"][:, tfsm.MAX_RGB] = bfT(d[8].weight)[:, 0]
    for name, _, _, _ in tfsm.SM90_LAYOUT_BWD:
        torch.testing.assert_close(mats[name], want[name], rtol=0, atol=0, msg=name)
    assert mats["wh"][:, num_rgb - 1].all() and mats["wh"][:, tfsm.MAX_RGB].all()


def _walk_k5b(port, x, acts, g_rgb, g_sig):
    """K5b's dX chain and dW walked on the host in its kernels' order over
    its buffers, with the reference's recomputed activations: the heads'
    gradients as one K = 144 product over the dX buffer's first matrix
    into dense 7, then w7..w1 down to dense 0 (JAX's _bwd_kernel:
    fused_sh_mlp.py:161-189); dW = A^T G over the stashes (x padded to 64,
    a0..a7; w5's rows [x | h4]) into the gradient buffer's layout, un-permuted
    by split_kernel_grads."""
    mats = _sm90_bwd_matrices(tfsm.kernel_weights_sm90_bwd(port).float())
    num_rgb = g_rgb.shape[1]
    pad = torch.nn.functional.pad
    pos = lambda a: (a > 0).float()  # noqa: E731
    xs = pad(x, (0, 1))
    gr, gs = pad(g_rgb, (0, tfsm.MAX_RGB - num_rgb)), pad(g_sig, (0, 127))
    g = {7: fm._mm(torch.cat([gr, gs[:, :16]], 1), mats["wh"].T) * pos(acts["a7"])}
    for l in range(6, -1, -1):
        g[l] = fm._mm(g[l + 1], mats[f"w{l + 1}"].T) * pos(acts[f"a{l}"])
    a_in = {0: xs, 5: torch.cat([xs, acts["a4"]], 1), **{l: acts[f"a{l - 1}"] for l in (1, 2, 3, 4, 6, 7)}}
    parts = [fm._mmT(a_in[l], g[l]) for l in range(8)] + [fm._mmT(acts["a7"], gs), fm._mmT(acts["a7"], gr)]
    parts += [g[l].sum(0) for l in range(8)] + [gs.sum(0), gr.sum(0)]
    return tfsm.split_kernel_grads(torch.cat([p.reshape(-1) for p in parts]))


@pytest.mark.parametrize("head", ["sh_deg 3", "num_rgb 128"])
def test_sm90_bwd_walk_matches_jax(mlps, jax_backward, wide, head):
    """K5b's buffers walked on the host in the kernels' layer order meet the
    backward rule against JAX's _fused_sh_bwd, on JAX's recomputed
    activations (sh_deg 3 and the widest head)."""
    (_, port, num_rgb), (want, acts) = (mlps[head], jax_backward[head]) if head in mlps else wide
    x, cot_rgb, cot_sig = (torch.from_numpy(a) for a in _inputs(3, num_rgb))
    assert_backward_near(_walk_k5b(port, x, acts, cot_rgb, cot_sig), want)


_SH_ENTRIES = [("weight_elems", "sm90::SH_WEIGHTS"), ("weight_t_elems", "sm90::SWT_SH_WEIGHTS"),
               ("grad_elems", "sh::GRAD_ELEMS")]


@pytest.mark.parametrize("entry, const", _SH_ENTRIES)
def test_k5b_reports_the_sm90_buffer_sizes(mlps, entry, const):
    """K5b's C interface reports the wgmma core's NeRF-SH buffer sizes, and
    those are the sizes of the buffers the route hands it (the forward's
    gather and the dX buffer) and of the gradient layout."""
    from tests.test_torch_fused_mlp import _sm90_constants

    ret = re.search(rf"long long fused_sh_bwd_{entry}\(\) {{ return ([\w:]+); }}", _csrc("fused_sh_bwd.cu")).group(1)
    assert ret == const
    value = (_sh_constants() if const.startswith("sh::") else _sm90_constants())[const.split("::")[1]]
    for _, port, _ in mlps.values():
        wk, wkt = tfsm.backward_weights(port, tfsm.forward_weights(port))
        assert value == {"weight_elems": wk.numel(), "weight_t_elems": wkt.numel(),
                         "grad_elems": tfsm.GRAD_ELEMS}[entry]


def test_kernels_refuse_host_tensors(mlps):
    _, port, num_rgb = mlps["sh_deg 2"]
    with pytest.raises(ValueError, match="CUDA"):
        tfsm.fused_sh_fwd(tfsm.forward_weights(port), torch.zeros(8, 63), num_rgb)
    with pytest.raises(ValueError, match="CUDA"):
        tfsm.fused_sh_bwd(*tfsm.backward_weights(port, tfsm.forward_weights(port)), torch.zeros(8, 63),
                          torch.zeros(8, num_rgb), torch.zeros(8, 1))


def test_fused_trunk_refuses_other_architectures():
    with pytest.raises(ValueError, match="fused SH trunk"):
        tfsm.fused_sh_apply(CondMLP(net_depth=4, net_width=64, num_rgb_channels=27), torch.zeros(4, 63), 27)
    with pytest.raises(ValueError, match="fused SH trunk"):
        tfsm.fused_sh_apply(CondMLP(in_ch_condition=27, num_rgb_channels=3), torch.zeros(4, 63), 3)


# ---------------------------------------------------------------------------
# K5f's buffer on the wgmma core (csrc/mlp_sm90.cuh)
# ---------------------------------------------------------------------------

def _port_mlp(num_rgb, seed):
    """A condition-free CondMLP with flax's init and seeded random biases."""
    gen = torch.Generator().manual_seed(seed)
    mlp = CondMLP(num_rgb_channels=num_rgb).reset_parameters(gen)
    with torch.no_grad():
        for layer in mlp.dense:
            layer.bias.copy_(torch.randn(layer.bias.shape, generator=gen) * 0.2)
    return mlp


def _sm90_matrices(wk):
    """K5f's buffer -> its [N][K] matrices by name (fused_mlp.sm90_slabs
    undone) and its biases by name."""
    from tests.test_torch_fused_mlp import _unslab

    mats, at = {}, 0
    for name, n, k, kd in tfsm.SM90_LAYOUT:
        mats[name] = _unslab(wk, at, n, k, kd)
        at += n * k
    biases = {}
    for name, n in tfsm.SM90_BIASES:
        biases[name] = wk[at: at + n]
        at += n
    assert at == wk.numel()
    return mats, biases


@pytest.mark.parametrize("num_rgb", [27, 48, 128])
def test_sm90_packing_maps_onto_pack_sh_params(num_rgb):
    """Unslabbed, K5f's buffer is pack_sh_params' padded weights (held to
    JAX's above) entry for entry: each matrix transposed to [out][in],
    dense 5's input rows in the kernels' [x | h] order, the sigma head's
    rows past 0 and the coefficient head's rows past num_rgb zero; then the
    biases. Each entry of the KERNEL_LAYOUT staging buffer appears once."""
    mlp = _port_mlp(num_rgb, num_rgb)
    W = tfsm.pack_sh_params(mlp)
    mats, biases = _sm90_matrices(tfsm.kernel_weights_sm90(mlp))
    want = {f"w{i}": getattr(W, f"w{i}").T for i in (0, 1, 2, 3, 4, 6, 7)}
    want["w5"] = torch.cat([W.w5[256:], W.w5[:256]]).T
    want["wsig"] = W.wsig.T[:8]
    want["wrgb"] = W.wrgb.T
    for name, _, _, _ in tfsm.SM90_LAYOUT:
        torch.testing.assert_close(mats[name], want[name], rtol=0, atol=0, msg=name)
    assert not mats["wsig"][1:].any() and mats["wsig"][0].any()
    assert not mats["wrgb"][num_rgb:].any() and mats["wrgb"][num_rgb - 1].any()
    for name, n in tfsm.SM90_BIASES:
        torch.testing.assert_close(biases[name], getattr(W, name)[0, :n], rtol=0, atol=0, msg=name)
    assert not biases["bsig"][1:].any() and not biases["brgb"][num_rgb:].any()

    probe = _probe(num_rgb)
    old, new = tfsm._build_kernel_weights(probe), tfsm._build_kernel_weights_sm90(probe)
    torch.testing.assert_close(torch.sort(new[new != 0]).values, torch.sort(old[old != 0]).values, rtol=0, atol=0)
    assert torch.unique(new[new != 0]).numel() == int((new != 0).sum())


def _sm90_source():
    return (Path(tfsm.__file__).resolve().parents[2] / "csrc" / "mlp_sm90.cuh").read_text()


def test_sm90_layout_matches_cuda_source():
    """SM90_LAYOUT's and SM90_BIASES' offsets are the trunk's SW_* and the
    head's SH_* constants of csrc/mlp_sm90.cuh; its layers are FWD_LAYERS'
    trunk (TRUNK_LAYERS of them) and SH_HEAD_LAYERS, the ring's table."""
    from tests.test_torch_fused_mlp import _cuda_layers, _sm90_constants

    env = _sm90_constants()
    at, offsets = 0, {}
    for name, n, k, _ in tfsm.SM90_LAYOUT:
        offsets[name] = at
        at += n * k
    for name in ("w0", "w1", "w5", "w6", "wsig"):
        assert env[f"SW_{name.upper()}"] == offsets[name], name
    assert env["SH_WRGB"] == offsets["wrgb"] and env["SH_B"] == at
    for name, n in tfsm.SM90_BIASES:
        if name in ("bsig", "brgb"):
            assert env[f"SH_{name.upper()}"] == at, name
        at += n
    assert env["SH_WEIGHTS"] == at
    trunk = int(re.search(r"constexpr int TRUNK_LAYERS = (\d+);", _sm90_source()).group(1))
    layers = [(n, k, kd) for _, n, k, kd in tfsm.SM90_LAYOUT]
    assert layers[:trunk] == _cuda_layers("FWD_LAYERS")[:trunk] and layers[trunk:] == _cuda_layers("SH_HEAD_LAYERS")
    assert int(re.search(r"constexpr int SH_MAX_RGB = (\d+);", _sm90_source()).group(1)) == tfsm.MAX_RGB


def test_k5f_reports_the_sm90_buffer_size(mlps):
    """K5f's C interface reports the wgmma core's NeRF-SH buffer size, the
    size of the buffer the route hands it."""
    src = (Path(tfsm.__file__).resolve().parents[2] / "csrc" / "fused_sh_fwd.cu").read_text()
    ret = re.search(r"long long fused_sh_fwd_weight_elems\(\) \{ return ([\w:]+); \}", src).group(1)
    assert ret == "sm90::SH_WEIGHTS"
    from tests.test_torch_fused_mlp import _sm90_constants

    for _, port, _ in mlps.values():
        assert tfsm.forward_weights(port).numel() == _sm90_constants()["SH_WEIGHTS"]


def test_route_draws_both_kernels_from_one_gather(mlps, monkeypatch):
    """The route gathers the wgmma core's forward buffer once, for K5f;
    K5b's backward reuses that tensor and gathers only its dX buffer."""
    _, port, num_rgb = mlps["sh_deg 3"]
    calls, real = [], fm.gather_weights
    monkeypatch.setattr(fm, "gather_weights", lambda m, layout, build: calls.append(layout) or real(m, layout, build))
    wf = tfsm.forward_weights(port)
    wk, wkt = tfsm.backward_weights(port, wf)
    assert wk is wf
    assert calls == [("fused_sh_sm90",), ("fused_sh_sm90_bwd",)]
    monkeypatch.undo()
    torch.testing.assert_close(wf, tfsm.kernel_weights_sm90(port), rtol=0, atol=0)
    torch.testing.assert_close(wkt, tfsm.kernel_weights_sm90_bwd(port), rtol=0, atol=0)


def test_sm90_buffer_walked_in_the_kernels_order_matches_jax(mlps, jax_forward):
    """A host walk of K5f's buffer in the order its kernel reads it (the
    trunk over [x | h4], the sigma head's row 0, the coefficient head's
    first num_rgb rows), with the kernel's bf16 rounding points, meets the
    forward rule against JAX's fused_sh_apply."""
    _, port, num_rgb = mlps["sh_deg 3"]
    mats, biases = _sm90_matrices(tfsm.kernel_weights_sm90(port).float())
    x = torch.nn.functional.pad(torch.from_numpy(_inputs(1, num_rgb)[0]), (0, 1))
    mm = fm._mm
    h = x
    for i in range(8):
        inp = torch.cat([x, h], dim=-1) if i == 5 else h
        h = torch.relu(mm(inp, mats[f"w{i}"].T) + biases[f"b{i}"])
    sig = mm(h, mats["wsig"].T)[:, :1] + biases["bsig"][:1]
    rgb = mm(h, mats["wrgb"].T)[:, :num_rgb] + biases["brgb"][:num_rgb]
    want_rgb, want_sig = jax_forward["sh_deg 3"]
    assert_forward_near(rgb.numpy(), want_rgb, "rgb")
    assert_forward_near(sig.numpy(), want_sig, "sigma")
