"""The port's raw-point fused MLP (K1rf forward, K1rb weight-gradient
backward: the positional encoding done in the kernel) against the JAX
package's ``fused_apply_raw`` (CPU).

On the CPU the port runs the kernels' plain versions; the JAX side runs
its Pallas kernels in interpret mode. Weights carry across through
``flax_to_state_dict``; inputs come from numpy seeds. The CUDA kernels are
held against the plain versions on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_projects_tpu.ops.pallas.fused_mlp as jfm
import nerf_projects_tpu_torch.ops.kernels.fused_mlp as tfm
from nerf_projects_tpu.models.nerf import NeRFMLP as FlaxNeRFMLP
from nerf_projects_tpu_torch.models.nerf import flax_to_state_dict
from nerf_projects_tpu_torch.ops.posenc import posenc
from tests.test_torch_fused_mlp import _carried, _flax_params, _unslab

N_ROWS = 300  # not a multiple of the kernel's 64-row tile nor of JAX's 768


@pytest.fixture(scope="module")
def full_width():
    """The 8x256 viewdirs MLP (the kernel fixes it): flax params with
    seeded random biases and the port's model holding them."""
    tree = _flax_params(FlaxNeRFMLP(depth=8, width=256, use_viewdirs=True), seed=11)
    return tree, _carried(tree, depth=8, width=256, use_viewdirs=True)


def _raw_inputs(seed, n):
    """Points U[-4, 4] (2^9 |p| reaches ~2,000 rad), unit view directions
    and an output cotangent."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    vd = rng.standard_normal((n, 3))
    vd = (vd / np.linalg.norm(vd, axis=-1, keepdims=True)).astype(np.float32)
    cot = rng.standard_normal((n, 4)).astype(np.float32)
    return pts, vd, cot


@pytest.fixture(scope="module")
def jax_raw(full_width):
    """JAX's fused_apply_raw on N_ROWS rows (it pads to 768): the output
    and, through jax.vjp, the padded raw-layout weight gradients of the
    cotangent (one interpret forward, one interpret backward)."""
    tree, _ = full_width
    pts, vd, cot = _raw_inputs(12, N_ROWS)
    old, jfm.INTERPRET = jfm.INTERPRET, True
    try:
        W = jfm.pack_params(tree, raw_layout=True)
        out, vjp = jax.vjp(lambda w: jfm.fused_apply_raw(w, jnp.asarray(pts), jnp.asarray(vd)), W)
        (gW,) = vjp(jnp.asarray(cot))
    finally:
        jfm.INTERPRET = old
    return np.asarray(out), gW


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / (np.abs(want).mean() + 1.0)


def test_raw_reference_matches_jax_interpret(full_width, jax_raw):
    """The plain K1rf against JAX's K1rf at full width on a ragged row
    count. Both encode in float32 with cos as sin(x + pi/2) and round to
    bf16 at the same points; float32 sums in another order move the odd
    activation across a bf16 rounding boundary: 1e-2 of the output
    scale, the bound of the encoded route's test."""
    _, model = full_width
    pts, vd, _ = _raw_inputs(12, N_ROWS)
    want, _ = jax_raw
    got = tfm.fused_apply_raw_reference(tfm.pack_params(model, raw_layout=True),
                                        torch.from_numpy(pts), torch.from_numpy(vd))
    assert tuple(got.shape) == want.shape == (N_ROWS, 4)
    assert _rel_err(got, want) < 1e-2


def test_fused_apply_raw_gradients_match_jax(full_width, jax_raw):
    """Gradients of a loss through the port's fused_apply_raw (the plain
    K1rb, then unpack_grads(raw_layout=True)) against JAX's vjp through
    its fused_apply_raw mapped by its unpack_grads(raw_layout=True). Every
    parameter gets a non-zero gradient. A flipped relu mask or bf16
    rounding moves a column of dW by ~1/sqrt(rows) of its size, so the
    bound is 0.05 of each tensor's largest entry, as for the encoded
    route; a wrong permutation moves whole rows (tens of percent)."""
    tree, model = full_width
    pts, vd, cot = _raw_inputs(12, N_ROWS)
    _, gW = jax_raw
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jfm.unpack_grads(gW, tree, raw_layout=True)))
    model.zero_grad(set_to_none=True)
    out = tfm.fused_apply_raw(model, torch.from_numpy(pts), torch.from_numpy(vd))
    (out * torch.from_numpy(cot)).sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.shape == p.shape, name
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.abs(g).max() > 0, name
        rel = np.abs(g - w).max() / (np.abs(w).max() + 1e-3)
        assert rel < 0.05, (name, rel)
    model.zero_grad(set_to_none=True)


def test_raw_backward_reference_matches_jax_padded_grads(full_width, jax_raw):
    """The plain K1rb's padded raw-layout gradients against JAX's K1rb's,
    field by field: the same rounding points (the encodings recomputed
    and rounded to bf16 by mmT), sums in another order: 1e-2 of each
    field's largest entry."""
    _, model = full_width
    pts, vd, cot = _raw_inputs(12, N_ROWS)
    _, gW = jax_raw
    p, v = tfm._pad_raw(torch.from_numpy(pts), torch.from_numpy(vd))
    g8 = torch.zeros(N_ROWS, 8)
    g8[:, 0:3], g8[:, 4] = torch.from_numpy(cot[:, :3]), torch.from_numpy(cot[:, 3])
    got = tfm.fused_mlp_raw_bwd_reference(tfm.pack_params(model, raw_layout=True), p, v, g8)
    for name in jfm.FusedMLPWeights._fields:
        gw = np.asarray(getattr(gW, name).astype(jnp.float32))
        gg = getattr(got, name).numpy()
        assert gg.shape == gw.shape, name
        rel = np.abs(gg - gw).max() / (np.abs(gw).max() + 1e-3)
        assert rel < 1e-2, (name, rel)


def test_raw_route_matches_encoded_route(full_width):
    """The raw route against the encoded one (posenc, then fused_apply) on
    the same points. The encodings are the same float32 values (posenc
    also takes cos as sin(x + pi/2)), but the raw layout permutes the
    input rows of trunk_0, trunk_5 and view_0, so those sums run in
    another order and an activation now and then rounds to the other bf16
    neighbour: held loosely, at the bounds of the JAX comparisons (1e-2
    of the output scale; gradients 0.05 of each tensor's largest entry)."""
    _, model = full_width
    pts, vd, cot = (torch.from_numpy(a) for a in _raw_inputs(13, 200))
    grads, outs = [], []
    for run in (lambda: tfm.fused_apply_raw(model, pts, vd),
                lambda: tfm.fused_apply(model, posenc(pts, 10), posenc(vd, 4))):
        model.zero_grad(set_to_none=True)
        out = run()
        (out * cot).sum().backward()
        outs.append(out.detach())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    assert _rel_err(outs[0], outs[1]) < 1e-2
    for name in grads[0]:
        g, w = grads[0][name], grads[1][name]
        rel = float((g - w).abs().max() / (w.abs().max() + 1e-3))
        assert rel < 0.05, (name, rel)


def test_fused_apply_raw_on_cpu_runs_the_plain_version(full_width):
    _, model = full_width
    pts, vd, _ = (torch.from_numpy(a) for a in _raw_inputs(14, 100))
    before = (tfm.fused_mlp_raw_fwd.launches, tfm.fused_mlp_raw_bwd.launches)
    model.zero_grad(set_to_none=True)
    got = tfm.fused_apply_raw(model, pts, vd)
    torch.testing.assert_close(
        got.detach(), tfm.fused_apply_raw_reference(tfm.pack_params(model, raw_layout=True), pts, vd),
        rtol=0, atol=0)
    got.square().sum().backward()
    assert model.trunk[0].weight.grad is not None
    assert (tfm.fused_mlp_raw_fwd.launches, tfm.fused_mlp_raw_bwd.launches) == before
    raw8 = tfm.fused_nerf_mlp_raw(model, *tfm._pad_raw(pts, vd)).detach()
    # the padded head columns are exactly zero
    assert float(raw8[:, 3].abs().max()) == 0.0 and float(raw8[:, 5:].abs().max()) == 0.0
    model.zero_grad(set_to_none=True)


def test_fused_apply_raw_carries_no_raw_points_tag():
    """As the reference's, so a caller of render_rays tags a wrapper."""
    assert not getattr(tfm.fused_apply_raw, "accepts_raw_points", False)


def test_fused_mlp_raw_fwd_refuses_host_tensors(full_width):
    _, model = full_width
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_raw_fwd(tfm.forward_weights(model, raw=True), torch.zeros(8, 8), torch.zeros(8, 8))


def test_fused_mlp_raw_bwd_refuses_host_tensors(full_width):
    _, model = full_width
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_raw_bwd(*tfm.backward_weights(model, True, tfm.forward_weights(model, raw=True)),
                              torch.zeros(8, 8), torch.zeros(8, 8), torch.zeros(8, 8))


def test_raw_kernels_build_over_the_shared_tile():
    """K1rf and K1rb include the wgmma core over the MLP tile, so an edit
    to either rebuilds both."""
    from nerf_projects_tpu_torch.ops.kernels import _build

    assert [p.name for p in _build.sources("fused_mlp_raw_fwd")] == [
        "fused_mlp_raw_fwd.cu", "mlp_sm90.cuh", "mlp_tile.cuh"]
    assert [p.name for p in _build.sources("fused_mlp_raw_bwd")] == [
        "fused_mlp_raw_bwd.cu", "mlp_sm90.cuh", "mlp_tile.cuh"]


def _sm90_forward(wk, x, v):
    """K1rf's core walked on the host: each layer's [N][K] matrix unslabbed
    from the kernel_weights_sm90 buffer in the order the kernel streams
    them, bf16 operands, float32 sums, activations rounded to bf16 ->
    [N, 8] (rgb head 0..3, sigma head 4..7)."""
    at, m, b = 0, {}, {}
    for name, n, k, kd in tfm.SM90_LAYOUT:
        m[name] = _unslab(wk, at, n, k, kd)
        at += n * k
    for name, n in tfm.SM90_BIASES:
        b[name] = wk[at: at + n]
        at += n
    assert at == wk.numel()

    def layer(a, name, bias, relu=True):
        h = a.to(torch.bfloat16).float() @ m[name].T + b[bias]
        return torch.relu(h) if relu else h

    h = layer(x, "w0", "b0")
    for i in (1, 2, 3, 4):
        h = layer(h, f"w{i}", f"b{i}")
    h = layer(torch.cat([x, h], 1), "w5", "b5")
    h = layer(layer(h, "w6", "b6"), "w7", "b7")
    sig = layer(h, "wsig", "bsig", relu=False)
    hv = layer(torch.cat([layer(h, "wb", "bb", relu=False), v], 1), "wv", "bv")
    rgb = layer(hv, "wrgb", "brgb", relu=False)
    return torch.cat([rgb[:, :4], sig[:, :4]], 1)


def test_sm90_slab_walk_matches_jax(full_width, jax_raw):
    """The wgmma core's weight stream (kernel_weights_sm90 in the raw
    layout, unslabbed in the kernel's layer order) run on the host over
    the encodings of _encode_tile against JAX's fused_apply_raw: the same
    rounding points, so within the 1e-2 of the plain K1rf's test."""
    _, model = full_width
    pts, vd, _ = _raw_inputs(12, N_ROWS)
    want, _ = jax_raw
    wk = tfm.kernel_weights_sm90(model, raw_layout=True).float()
    out = _sm90_forward(wk, *tfm._encode_raw(*tfm._pad_raw(torch.from_numpy(pts), torch.from_numpy(vd))))
    got = torch.cat([out[:, 0:3], out[:, 4:5]], 1)
    assert tuple(got.shape) == want.shape
    assert _rel_err(got, want) < 1e-2
