"""The port's rays, posenc, sampling and compositing against the JAX
package, on the same numpy inputs made from a seed (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.core import rays as jrays
from nerf_projects_tpu.ops.posenc import posenc as jax_posenc
from nerf_projects_tpu.ops import render as jrender
from nerf_projects_tpu.ops import sampling as jsampling
from nerf_projects_tpu_torch.core import rays as trays
from nerf_projects_tpu_torch.ops.posenc import posenc, posenc_dim
from nerf_projects_tpu_torch.ops import render as trender
from nerf_projects_tpu_torch.ops import sampling as tsampling

# float32 on both sides; the only differences are summation order and
# transcendental implementations, well under 1e-5 at these magnitudes.
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else got, np.asarray(want),
        rtol=tol, atol=tol,
    )


def _blender_K(size=800, focal=1111.11):
    return np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("theta,phi,radius", [(0.0, -30.0, 4.0), (123.4, -45.0, 4.031)])
def test_pose_spherical_matches(theta, phi, radius):
    np.testing.assert_array_equal(
        trays.pose_spherical(theta, phi, radius), jrays.pose_spherical(theta, phi, radius)
    )


def test_spherical_pose_path_matches():
    np.testing.assert_array_equal(trays.spherical_pose_path(8), jrays.spherical_pose_path(8))


@pytest.mark.parametrize("pixel_center", [0.0, 0.5])
def test_camera_rays_match(pixel_center):
    K = _blender_K(size=40, focal=55.5)
    c2w = jrays.pose_spherical(30.0, -30.0, 4.0)
    want = jrays.camera_rays(40, 48, K, c2w, pixel_center=pixel_center)
    got = trays.camera_rays(40, 48, K, c2w, pixel_center=pixel_center, device="cpu")
    assert got.batch_shape == (40, 48)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("ordering", ["interleaved", "block"])
@pytest.mark.parametrize("num_freqs,include_input", [(10, True), (4, True), (4, False)])
def test_posenc_matches(ordering, num_freqs, include_input):
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (257, 3)).astype(np.float32)
    want = jax_posenc(jnp.asarray(x), num_freqs, ordering=ordering, include_input=include_input)
    got = posenc(_t(x), num_freqs, ordering=ordering, include_input=include_input)
    assert got.shape[-1] == posenc_dim(3, num_freqs, include_input)
    _close(got, want)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_sample_deterministic_matches(lindisp):
    want = jsampling.stratified_sample(None, 64, 2.0, 6.0, (5,), lindisp=lindisp, randomized=False)
    got = tsampling.stratified_sample(None, 64, 2.0, 6.0, (5,), lindisp=lindisp, randomized=False)
    _close(got, want)


def test_stratified_sample_randomized_stays_in_strata():
    base = tsampling.stratified_sample(None, 16, 2.0, 6.0, (64,), randomized=False)
    g = torch.Generator().manual_seed(0)
    z = tsampling.stratified_sample(g, 16, 2.0, 6.0, (64,), randomized=True)
    again = tsampling.stratified_sample(torch.Generator().manual_seed(0), 16, 2.0, 6.0, (64,))
    torch.testing.assert_close(z, again, rtol=0, atol=0)
    mids = 0.5 * (base[..., 1:] + base[..., :-1])
    lower = torch.cat([base[..., :1], mids], -1)
    upper = torch.cat([mids, base[..., -1:]], -1)
    assert bool(((z >= lower) & (z <= upper)).all())
    assert bool((torch.diff(z, dim=-1) >= 0).all())


def _pdf_inputs(rng, rays=6, bins=33):
    z = np.sort(rng.uniform(2.0, 6.0, (rays, bins)), axis=-1).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (rays, bins - 1)).astype(np.float32)
    w[0] = 0.0  # an empty ray: the 1e-5 floor decides
    w[1, 5:] = 0.0
    return z, w


def test_piecewise_constant_pdf_deterministic_matches():
    z, w = _pdf_inputs(np.random.default_rng(1))
    want = jsampling.piecewise_constant_pdf(None, jnp.asarray(z), jnp.asarray(w), 48, randomized=False)
    got = tsampling.piecewise_constant_pdf(None, _t(z), _t(w), 48, randomized=False)
    _close(got, want)


@pytest.mark.parametrize("sorted_u", [False, True])
def test_piecewise_constant_pdf_fed_same_u(sorted_u):
    """The JAX draw's uniforms, reproduced from its key, go to the port."""
    z, w = _pdf_inputs(np.random.default_rng(2))
    key = jax.random.PRNGKey(3)
    want = jsampling.piecewise_constant_pdf(
        key, jnp.asarray(z), jnp.asarray(w), 40, randomized=True, sorted_u=sorted_u
    )
    draw = jsampling.sorted_uniform if sorted_u else jax.random.uniform
    u = np.asarray(draw(key, (z.shape[0], 40), dtype=jnp.float32))
    got = tsampling.piecewise_constant_pdf(None, _t(z), _t(w), 40, u=_t(u))
    _close(got, want)


def test_invert_cdf_edges_match():
    """u at 0, at 1, on cdf entries exactly, between them, outside [0, 1],
    and cdfs with flat runs (empty bins): the searchsorted brackets and
    their edge clamping equal the JAX masked min/max's, value for value."""
    rng = np.random.default_rng(5)
    z, w = _pdf_inputs(rng, rays=4, bins=9)
    w[2, ::2] = 0.0
    pdf = w / w.sum(-1, keepdims=True).clip(1e-12)
    cdf = np.concatenate([np.zeros((4, 1)), np.cumsum(pdf, -1)], -1).astype(np.float32)
    cdf[0] = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    u = np.concatenate([
        cdf[:, [0, 3, 8]], np.full((4, 1), 1.0), np.full((4, 1), -0.5), np.full((4, 1), 1.5),
        rng.uniform(0.0, 1.0, (4, 10)),
    ], -1).astype(np.float32)
    want = jsampling._invert_cdf(jnp.asarray(u), jnp.asarray(cdf), jnp.asarray(z))
    got = tsampling._invert_cdf(_t(u), _t(cdf), _t(z))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_sorted_uniform_is_sorted_in_unit_interval():
    u = tsampling.sorted_uniform(torch.Generator().manual_seed(0), (7, 50))
    assert bool((torch.diff(u, dim=-1) >= 0).all()) and 0 < float(u.min()) and float(u.max()) < 1


def test_merge_sorted_matches():
    rng = np.random.default_rng(4)
    a = np.sort(rng.uniform(0, 1, (5, 16)), -1).astype(np.float32)
    b = np.sort(rng.uniform(0, 1, (5, 24)), -1).astype(np.float32)
    b[:, 3] = a[:, 7]  # a tie
    want = jsampling.merge_sorted(jnp.asarray(a), jnp.asarray(b))
    got = tsampling.merge_sorted(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cast_rays_matches():
    rng = np.random.default_rng(5)
    z = rng.uniform(2, 6, (4, 9)).astype(np.float32)
    o, d = (rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2))
    _close(tsampling.cast_rays(_t(z), _t(o), _t(d)),
           jsampling.cast_rays(jnp.asarray(z), jnp.asarray(o), jnp.asarray(d)))


def _render_inputs(rng, rays=16, n=24):
    rgb = rng.uniform(0, 1, (rays, n, 3)).astype(np.float32)
    sigma = np.maximum(rng.standard_normal((rays, n)), 0).astype(np.float32) * 3
    z = np.sort(rng.uniform(2, 6, (rays, n)), -1).astype(np.float32)
    d = rng.standard_normal((rays, 3)).astype(np.float32)
    return rgb, sigma, z, d


def test_compute_alpha_weights_matches():
    _, sigma, z, d = _render_inputs(np.random.default_rng(6))
    want = jrender.compute_alpha_weights(jnp.asarray(sigma), jnp.asarray(z), jnp.asarray(d))
    got = trender.compute_alpha_weights(_t(sigma), _t(z), _t(d))
    for g, w in zip(got, want):
        _close(g, w)


def _grad_of_weights(fn, sigma, z, d, cot):
    """The weights and, but for the last sample's, the gradient of
    sum(weights * cot) in sigma: the last sample's distance is the 1e10
    tail, so where its sigma is 0 its own gradient is ~1e10 and would
    hide the transmittance's part in any bound relative to the largest."""
    sigma = _t(sigma).requires_grad_(True)
    _, w = fn(sigma, _t(z), _t(d))
    (g,) = torch.autograd.grad((w * _t(cot)).sum(), sigma)
    return w, g[..., :-1]


def _alpha_inputs(seed):
    """Rays whose samples run from transparent to opaque (alpha near 1:
    factors 1 - alpha + 1e-10 near 1e-10), and one empty ray."""
    rng = np.random.default_rng(seed)
    _, sigma, z, d = _render_inputs(rng)
    sigma[0] = 0.0
    sigma[1, 5:] = 1e4
    cot = rng.standard_normal(sigma.shape).astype(np.float32)
    return sigma, z, d, cot


def test_transmittance_gradient_needs_no_cumprod_backward():
    """torch.cumprod's backward tests its input for zeros on the host, so
    on a card it waits for the queue; the weights' graph holds none."""
    sigma, z, d, _ = _alpha_inputs(8)
    _, w = trender.compute_alpha_weights(_t(sigma).requires_grad_(True), _t(z), _t(d))
    seen, todo = set(), [w.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [f for f, _ in fn.next_functions]
    names = {type(fn).__name__ for fn in seen}
    assert "CumprodBackward0" not in names and any("Cumprod" in n for n in names), names


def test_transmittance_matches_torch_cumprod_autograd():
    """The weights are the same bits as through torch.cumprod, and their
    gradient equals autograd's through torch.cumprod: both are the reverse
    cumulative sum of g * trans over the factor, so only the order of
    float32 sums differs: 1e-6 of the gradient's scale."""
    sigma, z, d, cot = _alpha_inputs(9)
    w, g = _grad_of_weights(trender.compute_alpha_weights, sigma, z, d, cot)
    w_ref, g_ref = _grad_of_weights(trender.compute_alpha_weights_reference, sigma, z, d, cot)
    assert torch.equal(w, w_ref)
    assert float(g.abs().max()) > 0
    scale = float(g_ref.abs().max())
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=0, atol=1e-6 * scale)


def test_transmittance_gradient_matches_jax():
    """The weights' gradient against jax.grad of JAX's
    compute_alpha_weights (its cumprod differentiates through a scan):
    float32 both sides, 1e-5 of the gradient's scale."""
    sigma, z, d, cot = _alpha_inputs(10)
    _, g = _grad_of_weights(trender.compute_alpha_weights, sigma, z, d, cot)
    want = jax.grad(lambda s: jnp.sum(jrender.compute_alpha_weights(s, jnp.asarray(z), jnp.asarray(d))[1]
                                      * jnp.asarray(cot)))(jnp.asarray(sigma))
    want = np.asarray(want)[..., :-1]
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_volumetric_rendering_matches(white_bkgd):
    rgb, sigma, z, d = _render_inputs(np.random.default_rng(7))
    sigma[0] = 0.0  # an empty ray: acc 0, disp from the 1e-10 guards
    want = jrender.volumetric_rendering(
        *(jnp.asarray(a) for a in (rgb, sigma, z, d)), white_bkgd=white_bkgd
    )
    got = trender.volumetric_rendering(*(_t(a) for a in (rgb, sigma, z, d)), white_bkgd=white_bkgd)
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name))


def test_posenc_and_stratified_sample_copy_no_host_numbers_after_their_first_call(monkeypatch):
    """posenc's frequency and phase tables and stratified_sample's scalar
    near and far come from tensors kept on the device: on the card a
    copy of host numbers (torch.tensor, torch.as_tensor) waits for the
    queue to drain, once per call."""
    x = _t(np.random.default_rng(5).standard_normal((7, 3)))

    def run():
        return (posenc(x, 10, ordering="block"), posenc(x, 4),
                tsampling.stratified_sample(None, 16, 2.0, 6.0, (7,), randomized=False))

    first = run()
    copies = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            copies.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch, name, counted)
    again = run()
    monkeypatch.undo()
    assert copies == []
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
