"""The port's coarse+fine rendering against the JAX package (CPU), and
the render half of the port's trainer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_projects_tpu.ops.pallas.fused_mlp as jfm
import nerf_projects_tpu_torch.ops.kernels.fused_mlp as tfm
from nerf_projects_tpu.core.rays import Rays as JaxRays
from nerf_projects_tpu.core.rays import camera_rays as jax_camera_rays
from nerf_projects_tpu.models.nerf import NeRFMLP as FlaxNeRFMLP
from nerf_projects_tpu.models.pipeline import NeRFRenderConfig as JaxConfig
from nerf_projects_tpu.models.pipeline import render_rays as jax_render_rays
from nerf_projects_tpu_torch.core import rays as trays
from nerf_projects_tpu_torch.core.rays import Rays, pose_spherical
from nerf_projects_tpu_torch.models.nerf import NeRFMLP, flax_to_state_dict
from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig, render_rays
from nerf_projects_tpu_torch.train import NeRFTrainer
from tests.test_torch_fused_mlp import random_biases

FOCAL, SIZE = 1111.11, 800


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jfm.INTERPRET
    jfm.INTERPRET = True
    yield
    jfm.INTERPRET = old


def _blender_rays(n_rays, seed):
    """n_rays random pixels of an 800x800 Blender camera, as numpy."""
    K = np.array([[FOCAL, 0, SIZE / 2], [0, FOCAL, SIZE / 2], [0, 0, 1]], np.float32)
    rays = jax_camera_rays(SIZE, SIZE, K, pose_spherical(40.0, -30.0, 4.0))
    idx = np.random.default_rng(seed).choice(SIZE * SIZE, n_rays, replace=False)
    return [np.asarray(f).reshape(-1, 3)[idx] for f in rays]


def _flax_and_port(depth, width, seeds=(0, 1), skips=(4,)):
    """Flax-initialised trees with seeded random biases, and the port's
    models holding them."""
    model = FlaxNeRFMLP(depth=depth, width=width, skips=skips, use_viewdirs=True)
    init = jax.jit(model.init)
    trees, ports = [], []
    for s in seeds:
        tree = random_biases(jax.tree_util.tree_map(
            np.asarray, init(jax.random.PRNGKey(s), jnp.zeros((1, 63)), jnp.zeros((1, 27)))
        ), s)
        port = NeRFMLP(depth=depth, width=width, skips=skips, use_viewdirs=True)
        port.load_state_dict(flax_to_state_dict(tree))
        trees.append(tree)
        ports.append(port)
    return model, trees, ports


def _jax_render(apply_fn, trees, rays, cfg):
    render = jax.jit(lambda pc, pf, r: jax_render_rays(
        None, pc, pf, apply_fn, r, 2.0, 6.0, JaxConfig(**cfg), randomized=False
    ))
    return render(trees[0], trees[1], JaxRays(*rays))


def _compare(got, want, tol, depth_tol=None):
    for key in ("rgb", "acc", "depth", "rgb0", "acc0"):
        atol = depth_tol if key == "depth" and depth_tol is not None else tol
        np.testing.assert_allclose(
            got[key].detach().numpy(), np.asarray(want[key]), rtol=0, atol=atol, err_msg=key
        )


def test_render_rays_matches_jax_plain_mlp():
    """Narrow float32 MLPs, coarse+fine, randomized=False. rgb and acc
    (unitless, in [0, 1]) within 1e-3: float32 on both sides, differing
    in summation order only. depth is in scene units (rays end at
    far = 6) and is held to 1e-3 of far: the two cumsums of the pdf
    round differently by ~1e-7, and where the last bin's pdf is only its
    1e-5 floor that moves the u = 1 fine sample by ~1% of a bin width
    (1e-3 in z), which depth, a weighted sum of z, shows."""
    cfg = dict(num_coarse_samples=32, num_fine_samples=64, white_bkgd=True, perturb=False)
    flax_model, trees, ports = _flax_and_port(4, 64, skips=(2,))
    o, d, vd = _blender_rays(64, seed=0)
    want = _jax_render(flax_model.apply, trees, (o, d, vd), cfg)
    got = render_rays(
        None, ports[0], ports[1], lambda m, p, v: m(p, v),
        Rays(*(torch.from_numpy(a) for a in (o, d, vd))), 2.0, 6.0,
        NeRFRenderConfig(**cfg), randomized=False,
    )
    _compare(got, want, 1e-3, depth_tol=1e-3 * 6.0)


def test_render_rays_matches_jax_fused_mlp():
    """8x256: the JAX side through its Pallas kernel (interpret mode),
    the port through the kernel's plain version; 32 rays at 16+32
    samples. 1e-2 for rgb and acc, and 1e-2 of far for depth (scene
    units, as above): both round to bf16 at the same points but sum in
    another order, so an activation now and then rounds to the other
    bf16 neighbour, and the fine depths move with the coarse weights."""
    cfg = dict(num_coarse_samples=16, num_fine_samples=32, white_bkgd=True, perturb=False)
    _, trees, ports = _flax_and_port(8, 256)
    o, d, vd = _blender_rays(32, seed=1)
    want = _jax_render(lambda p, x, v: jfm.fused_apply(jfm.pack_params(p), x, v), trees, (o, d, vd), cfg)
    packed = [tfm.pack_params(p) for p in ports]
    got = render_rays(
        None, packed[0], packed[1], tfm.fused_apply_reference,
        Rays(*(torch.from_numpy(a) for a in (o, d, vd))), 2.0, 6.0,
        NeRFRenderConfig(**cfg), randomized=False,
    )
    _compare(got, want, 1e-2, depth_tol=1e-2 * 6.0)


def _tagged(fn):
    """A wrapper tagged ``accepts_raw_points``, as a caller of render_rays
    tags its raw apply (neither package's fused_apply_raw carries it)."""
    def apply(params, pts, viewdirs):
        return fn(params, pts, viewdirs)
    apply.accepts_raw_points = True
    return apply


def test_query_mlp_hands_a_tagged_apply_raw_points():
    """An apply tagged accepts_raw_points gets the flat raw sample points
    and each row's view direction, whatever the config's posenc settings
    (the reference's _query_mlp); an untagged one gets the encodings."""
    from nerf_projects_tpu_torch.ops.sampling import cast_rays, stratified_sample

    cfg = NeRFRenderConfig(num_coarse_samples=5, num_fine_samples=0, multires=6,
                           posenc_ordering="block", use_viewdirs=False, perturb=False)
    rays = _image_rays(2, 3).map(lambda t: t.reshape(-1, 3))
    seen = []

    def raw_apply(params, pts, viewdirs):
        seen.append((pts, viewdirs))
        return torch.zeros(pts.shape[0], 4)

    raw_apply.accepts_raw_points = True
    render_rays(None, None, None, raw_apply, rays, 2.0, 6.0, cfg, randomized=False)
    z = stratified_sample(None, 5, 2.0, 6.0, (6,), randomized=False, device="cpu")
    pts = cast_rays(z, rays.origins, rays.directions)
    (got_pts, got_vd), = seen
    torch.testing.assert_close(got_pts, pts.reshape(30, 3), rtol=0, atol=0)
    torch.testing.assert_close(got_vd, rays.viewdirs.repeat_interleave(5, dim=0), rtol=0, atol=0)

    seen.clear()
    render_rays(None, None, None, lambda params, x: seen.append((x,)) or torch.zeros(x.shape[0], 4),
                rays, 2.0, 6.0, cfg, randomized=False)
    assert seen[0][0].shape == (30, 3 * (2 * 6 + 1))


def test_render_rays_raw_route_matches_jax(monkeypatch):
    """The raw-points route, coarse + fine at 8x256: the port's render_rays
    with a tagged fused_apply_raw (K1rf's plain version) against JAX's
    render_rays with a tagged fused_apply_raw (its Pallas kernel in
    interpret mode), 16 rays at 16 + 32 samples, randomized=False. Both
    sides take the port's fine depths (patched into JAX's pipeline): bf16
    noise in the coarse weights moves the resample (ROADMAP, limits of
    comparison). With the depths shared only the MLP's order noise is
    left (an activation now and then rounding to the other bf16
    neighbour; below 1e-4 here): rgb and acc within 2e-3, depth within
    2e-3 of far."""
    import nerf_projects_tpu.models.pipeline as jpipe
    import nerf_projects_tpu_torch.models.pipeline as tpipe

    cfg = dict(num_coarse_samples=16, num_fine_samples=32, white_bkgd=True, perturb=False)
    _, trees, ports = _flax_and_port(8, 256, seeds=(3, 4))
    o, d, vd = _blender_rays(16, seed=5)
    port_pdf, fine_z = tpipe.piecewise_constant_pdf, []

    def recording_pdf(*args, **kwargs):
        fine_z.append(port_pdf(*args, **kwargs))
        return fine_z[-1]

    monkeypatch.setattr(tpipe, "piecewise_constant_pdf", recording_pdf)
    got = render_rays(
        None, ports[0], ports[1], _tagged(tfm.fused_apply_raw),
        Rays(*(torch.from_numpy(a) for a in (o, d, vd))), 2.0, 6.0,
        NeRFRenderConfig(**cfg), randomized=False,
    )
    monkeypatch.setattr(jpipe, "piecewise_constant_pdf",
                        lambda *args, **kwargs: jnp.asarray(fine_z[0].numpy()))
    want = _jax_render(
        _tagged(lambda p, x, v: jfm.fused_apply_raw(jfm.pack_params(p, raw_layout=True), x, v)),
        trees, (o, d, vd), cfg)
    _compare(got, want, 2e-3, depth_tol=2e-3 * 6.0)
    assert float(np.abs(np.asarray(want["acc"])).max()) > 0.1


def _cfg(**kw):
    base = dict(num_coarse_samples=8, num_fine_samples=16, white_bkgd=True, perturb=False)
    base.update(kw)
    return NeRFRenderConfig(**base)


def _image_rays(h=6, w=7):
    K = np.array([[FOCAL, 0, SIZE / 2], [0, FOCAL, SIZE / 2], [0, 0, 1]], np.float32)
    return trays.camera_rays(SIZE, SIZE, K, pose_spherical(10.0, -30.0, 4.0), device="cpu").map(
        lambda t: t[400:400 + h, 390:390 + w]
    )


@pytest.mark.parametrize(
    "kw,fused",
    [
        ({}, True),
        ({"depth": 4}, False),
        ({"width": 128}, False),
        ({"cfg": {"multires": 6}}, False),
        ({"cfg": {"use_viewdirs": False}}, False),
    ],
)
def test_trainer_fused_gate(kw, fused):
    kw = dict(kw)
    cfg = _cfg(**kw.pop("cfg", {}))
    assert NeRFTrainer(cfg, use_fused_mlp=True, device="cpu", **kw).use_fused_mlp is fused
    assert NeRFTrainer(cfg, use_fused_mlp=False, device="cpu", **kw).use_fused_mlp is False


def test_trainer_render_image_chunks_with_edge_padding():
    tr = NeRFTrainer(_cfg(), depth=2, width=32, device="cpu")
    params = tr.init_params(0)
    rays = _image_rays()
    whole = tr.render_step(params, rays.map(lambda t: t.reshape(-1, 3)))
    img = tr.render_image(params, rays, chunk=16)  # 42 rays: 16 + 16 + 10 padded
    assert img["rgb"].shape == (6, 7, 3) and img["weights"].shape == (6, 7, 24)
    for k, v in whole.items():
        torch.testing.assert_close(img[k].reshape(v.shape), v, rtol=1e-6, atol=1e-6)


def test_trainer_fused_render_on_cpu_is_the_plain_version():
    """Serving through the fused MLP (use_kernel=True) on host tensors
    goes through the kernel's plain version: equal to render_rays over
    fused_apply_reference."""
    cfg = _cfg()
    tr = NeRFTrainer(cfg, use_fused_mlp=True, device="cpu")
    params = tr.init_params(7)
    rays = _image_rays(3, 4).map(lambda t: t.reshape(-1, 3))
    got = tr.render_image(params, rays, chunk=8, use_kernel=True)
    want = render_rays(
        None, tfm.pack_params(params[0]), tfm.pack_params(params[1]),
        tfm.fused_apply_reference, rays, 2.0, 6.0, cfg, randomized=False,
    )
    for k in ("rgb", "acc", "depth", "rgb0"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
    assert bool(torch.isfinite(got["rgb"]).all())


def test_trainer_render_step_follows_the_reference_with_fused_mlp():
    """A use_fused_mlp=True trainer serves, by default, through the
    float32 modules as the reference's render_step does (it never uses
    the fused kernel for eval): held against JAX's render_step on the
    same weights at float32 tolerances (1e-4 on rgb and acc, 1e-4 of far
    on depth: summation order only). Asking for the kernel without the
    gate raises."""
    from nerf_projects_tpu.train.nerf_trainer import NeRFTrainer as JaxTrainer

    cfg = dict(num_coarse_samples=8, num_fine_samples=16, white_bkgd=True, perturb=False)
    _, trees, ports = _flax_and_port(8, 256)
    o, d, vd = _blender_rays(12, seed=2)
    jtr = JaxTrainer(JaxConfig(**cfg), depth=8, width=256, use_fused_mlp=True)
    want = jtr.render_step((trees[0], trees[1]), JaxRays(*(jnp.asarray(a) for a in (o, d, vd))))
    tr = NeRFTrainer(NeRFRenderConfig(**cfg), use_fused_mlp=True, device="cpu")
    assert tr.use_fused_mlp
    got = tr.render_step(tuple(ports), Rays(*(torch.from_numpy(a) for a in (o, d, vd))))
    _compare(got, want, 1e-4, depth_tol=1e-4 * 6.0)
    with pytest.raises(ValueError, match="use_fused_mlp"):
        NeRFTrainer(_cfg(), depth=2, width=32, device="cpu").render_step(
            tr.init_params(0), Rays(*(torch.from_numpy(a) for a in (o, d, vd))), use_kernel=True)


def test_init_params_is_seeded_and_separate():
    tr = NeRFTrainer(_cfg(), depth=2, width=32, device="cpu")
    c1, f1 = tr.init_params(5)
    c2, _ = tr.init_params(5)
    torch.testing.assert_close(c1.trunk[0].weight, c2.trunk[0].weight, rtol=0, atol=0)
    assert not torch.equal(c1.trunk[0].weight, f1.trunk[0].weight)
    assert NeRFTrainer(_cfg(num_fine_samples=0), device="cpu").init_params(0)[1] is None


def test_randomized_render_is_reproducible_from_a_generator():
    tr = NeRFTrainer(_cfg(perturb=True, raw_noise_std=1.0), depth=2, width=32, device="cpu")
    params = tr.init_params(1)
    rays = _image_rays(2, 3).map(lambda t: t.reshape(-1, 3))

    def run(seed):
        return render_rays(
            torch.Generator().manual_seed(seed), params[0], params[1],
            lambda m, p, v: m(p, v), rays, 2.0, 6.0, tr.cfg, randomized=True,
        )

    a, b, c = run(3), run(3), run(4)
    torch.testing.assert_close(a["rgb"], b["rgb"], rtol=0, atol=0)
    assert not torch.equal(a["rgb"], c["rgb"])
    with pytest.raises(ValueError, match="generator"):
        render_rays(None, params[0], params[1], lambda m, p, v: m(p, v), rays, 2.0, 6.0,
                    tr.cfg, randomized=True)


def test_entry_points_default_to_the_card(monkeypatch):
    """device=None means cuda: without a card the entry points raise
    instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NeRFTrainer(_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trays.camera_rays(4, 4, np.eye(3), np.eye(4))
