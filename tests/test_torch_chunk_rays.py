"""The port's tree handling in ``core/chunk.py`` (a NamedTuple output and a
``None`` leaf through ``chunk_apply`` and ``render_rays_sharded``) and four
small functions (``core/rays.py::ndc_rays_opencv`` and ``equirect_rays``,
``ops/sg.py::euler2mat``, ``ops/tv.py::l2_color_grad``'s ``mask``) against
the JAX package's, on the same seeded numpy inputs.

Tolerances: 1e-6 relative (and 1e-6 absolute, for entries near zero) on
float32 ray, compositing and rotation math; the chunked and sharded
results equal the unchunked ones bit for bit (the same ops on the same
rows); the mask's zero rows are exactly zero.
"""
import numpy as np
import pytest
import torch

from nerf_projects_tpu_torch.core.chunk import chunk_apply, tree_leaves, tree_map
from nerf_projects_tpu_torch.core.rays import Rays, equirect_rays, ndc_rays_opencv
from nerf_projects_tpu_torch.ops.render import RenderOutputs, volumetric_rendering

RTOL = ATOL = 1e-6


def composite_inputs(n=37, s=6, seed=0):
    """Per-sample colours, densities, sorted depths and directions of n rays."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(n, s, 3)).astype(np.float32)
    sigma = rng.uniform(0, 3, size=(n, s)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, size=(n, s)), -1).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return {"rgb": rgb, "sigma": sigma, "z": z, "d": d}


def test_chunk_apply_keeps_a_named_tuple_as_jax_does():
    """An fn that returns ``RenderOutputs``: JAX's chunk_apply returns its
    NamedTuple; the port's did not (``type(tree)(generator)`` passed one
    argument to its ``__new__``) and now returns the port's, equal to
    JAX's and, bit for bit, to fn on the whole batch."""
    import jax.numpy as jnp

    from nerf_projects_tpu.core.chunk import chunk_apply as jchunk
    from nerf_projects_tpu.ops.render import volumetric_rendering as jcomposite

    x = composite_inputs()
    want = jchunk(lambda t: jcomposite(t["rgb"], t["sigma"], t["z"], t["d"]),
                  {k: jnp.asarray(v) for k, v in x.items()}, 8)
    tree = {k: torch.from_numpy(v) for k, v in x.items()}
    got = chunk_apply(lambda t: volumetric_rendering(t["rgb"], t["sigma"], t["z"], t["d"]), tree, 8)
    whole = volumetric_rendering(tree["rgb"], tree["sigma"], tree["z"], tree["d"])
    assert type(want).__name__ == "RenderOutputs" and isinstance(got, RenderOutputs)
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=RTOL, atol=ATOL)
        assert torch.equal(getattr(got, name), getattr(whole, name)), name


def test_chunk_apply_keeps_a_none_leaf_as_jax_does():
    """An fn that returns {"a": tensor, "b": None}: JAX keeps the None; the
    port raised ``TypeError: not a tensor tree: NoneType`` and now keeps
    it, and ``tree_leaves`` skips it as ``jax.tree_util`` does."""
    import jax.numpy as jnp

    from nerf_projects_tpu.core.chunk import chunk_apply as jchunk

    x = np.random.default_rng(1).standard_normal((37, 3)).astype(np.float32)
    want = jchunk(lambda t: {"a": jnp.tanh(t) * 2.0, "b": None}, jnp.asarray(x), 8)
    got = chunk_apply(lambda t: {"a": torch.tanh(t) * 2.0, "b": None}, torch.from_numpy(x), 8)
    assert want["b"] is None and got["b"] is None
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), rtol=RTOL, atol=ATOL)
    assert len(tree_leaves({"a": got["a"], "b": None, "c": (None, got["a"])})) == 2
    with pytest.raises(TypeError, match="not a tensor tree: str"):
        tree_map(lambda t: t, {"a": "text"})


def test_render_rays_sharded_returns_a_named_tuple_on_a_one_rank_group(tmp_path):
    """``render_rays_sharded`` on the mesh of a one-rank gloo group (no
    spawn) with an fn that returns ``RenderOutputs``, with and without
    chunks: the same NamedTuple of numpy arrays as fn on the whole batch."""
    import torch.distributed as dist

    from nerf_projects_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from nerf_projects_tpu_torch.parallel.render import render_rays_sharded

    rng = np.random.default_rng(2)
    o, d = (rng.standard_normal((45, 3)).astype(np.float32) for _ in range(2))
    rays = Rays(*(torch.from_numpy(v) for v in (o, d, d)))
    z = torch.linspace(2.0, 6.0, 8)

    def fn(r):
        n = r.origins.shape[0]
        sigma = torch.relu(r.origins.sum(-1, keepdim=True) + z)
        rgb = torch.sigmoid(r.directions[:, None, :] * z[:, None])
        return volumetric_rendering(rgb, sigma, z.expand(n, -1), r.directions)

    init_distributed(device="cpu", rank=0, world_size=1, init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        mesh = make_mesh(device="cpu")
        whole = fn(rays)
        for chunk in (None, 16):
            got = render_rays_sharded(mesh, fn, rays, chunk=chunk)
            assert isinstance(got, RenderOutputs)
            for name in RenderOutputs._fields:
                np.testing.assert_array_equal(getattr(got, name), getattr(whole, name).numpy())
    finally:
        dist.destroy_process_group()


def test_ndc_rays_opencv_matches_jax():
    """Forward-facing OpenCV rays (+z) through the Plenoxels NDC warp."""
    import jax.numpy as jnp

    from nerf_projects_tpu.core.rays import ndc_rays_opencv as jndc

    rng = np.random.default_rng(3)
    o = rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32) * 0.3
    d[:, 2] = rng.uniform(0.8, 1.2, 64)
    coeffs = (2 * 400.0 / 504, 2 * 400.0 / 378)
    want_o, want_d = jndc(jnp.asarray(o), jnp.asarray(d), coeffs)
    got_o, got_d = ndc_rays_opencv(torch.from_numpy(o), torch.from_numpy(d), coeffs)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got_d.numpy(), axis=-1), 1.0, rtol=RTOL)


def test_equirect_rays_match_jax_and_cover_the_sphere():
    """tests/test_interop_misc.py's TestEquirect on the port, and the port's
    rays against JAX's under a seeded rotation and translation."""
    import jax
    from scipy.spatial.transform import Rotation

    from nerf_projects_tpu.core.rays import equirect_rays as jequirect

    rays = equirect_rays(32, 64, np.eye(4), device="cpu")
    d = rays.directions.reshape(-1, 3).numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert d[:, 1].min() < -0.9 and d[:, 1].max() > 0.9
    assert np.abs(d.mean(0)).max() < 0.1

    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_rotvec([0.3, -0.7, 0.2]).as_matrix()
    c2w[:3, 3] = [0.5, -1.0, 2.0]
    want = jax.jit(jequirect, static_argnums=(0, 1))(16, 40, c2w)  # eager, each of its ops compiles alone
    got = equirect_rays(16, 40, c2w, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == (16, 40, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_euler2mat_matches_jax():
    """tests/test_sh_sg.py's identity case, then seeded angles [5, 4, 3]."""
    import jax.numpy as jnp

    from nerf_projects_tpu.ops.sg import euler2mat as jeuler2mat
    from nerf_projects_tpu_torch.ops.sg import euler2mat

    np.testing.assert_allclose(euler2mat(torch.zeros(3)).numpy(), np.eye(3), atol=1e-6)
    a = np.random.default_rng(4).uniform(-np.pi, np.pi, (5, 4, 3)).astype(np.float32)
    got = euler2mat(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jeuler2mat(jnp.asarray(a))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), np.broadcast_to(np.eye(3), got.shape), atol=1e-5)


@pytest.mark.parametrize("mask_rows", [None, 10, 0])
def test_l2_color_grad_mask_matches_jax(mask_rows):
    """tests/test_tv_losses.py's formula case: all rows, the first 10 rows,
    and an empty mask (no row: the count is clamped to 1)."""
    import jax.numpy as jnp

    from nerf_projects_tpu.ops.tv import l2_color_grad as jl2
    from nerf_projects_tpu_torch.ops.tv import l2_color_grad

    sh = np.random.default_rng(0).standard_normal((50, 27)).astype(np.float32)
    mask = None if mask_rows is None else np.arange(50) < mask_rows
    want = np.asarray(jl2(jnp.asarray(sh), scale=0.5, mask=None if mask is None else jnp.asarray(mask)))
    got = l2_color_grad(torch.from_numpy(sh), scale=0.5, mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if mask is not None:
        assert (got[~mask] == 0).all()
        np.testing.assert_allclose(got[mask], 0.5 / max(mask_rows, 1) * sh[mask], rtol=RTOL)


def test_sh_degree_limit_matches_jax():
    from nerf_projects_tpu.ops.sh import MAX_SH_DEGREE as jmax
    from nerf_projects_tpu_torch.ops.sh import MAX_SH_DEGREE

    assert MAX_SH_DEGREE == jmax == 4
