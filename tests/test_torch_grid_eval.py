"""The rest of the port's ``ops/grid.py`` against the JAX package (CPU): the
dense density cache, ``sample_grid``, both modes of
``volume_render_depth``, learned bases through ``sh_mult``, the nvol and
svox1 backends, the top-K colour route with and without the cache, both
background models composited behind the grid, and ``cli/render_imgs.py``'s
default (fast) route against the JAX CLI's.

Inputs come from seeded numpy and go to both sides. Float32 on both
sides, so the tolerances are float32 ones (1e-5), sums in another order;
the bf16 cache is the same bf16 rounding on both sides."""
import functools
import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.cli import render_imgs as jri
from nerf_projects_tpu.data.base import load_scene as jax_load_scene
from nerf_projects_tpu.models.sparse_grid import SparseGrid as JaxSparseGrid
from nerf_projects_tpu.ops import background as jbgm
from nerf_projects_tpu.ops import grid as jgrid
from nerf_projects_tpu.ops import grid_accel as jacc
from nerf_projects_tpu_torch.cli import render_imgs as tri
from nerf_projects_tpu_torch.data.base import load_scene
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.ops import background as tbgm
from nerf_projects_tpu_torch.ops import grid as tgrid
from nerf_projects_tpu_torch.ops import grid_accel as tacc
from tests.test_torch_grid import both_rays, close, random_grids, random_rays
from tests.test_torch_render_imgs import make_blender_scene

TOL = dict(rtol=1e-5, atol=1e-5)
N_RAYS = 32  # one ray count and one grid shape throughout: JAX's op-by-op run compiles each op once a shape
OUT_KEYS = ("rgb", "acc", "weights", "sigma", "log_transmit")


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def jitted(fn, *args, static=(), **kw):
    """fn(*args, **kw) through jax.jit (a whole render compiles in ~0.6 s
    on the CPU, op by op in ~7 s); the keywords named in ``static`` and
    the occupancy grid are closed over, the other keywords traced."""
    fixed = {k: kw.pop(k) for k in list(kw) if k in static or k == "occupancy"}
    return jax.jit(lambda a, k: functools.partial(fn, **fixed)(*a, **k))(args, kw)


def render_both(jg, tg, jr, tr, jopts=None, topts=None, **kw):
    jkw = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    tkw = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    want = jitted(jgrid.volume_render_grid, jg, jr, opts=jopts or jgrid.GridRenderOptions(),
                  static=("opts", "return_depth", "active_steps", "color_top_k"), **jkw)
    got = tgrid.volume_render_grid(tg, tr, topts or tgrid.GridRenderOptions(), **tkw)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_render_cache_matches_jax(dtype):
    jg, tg = random_grids(16, 4, seed=30)
    want = jgrid.make_render_cache(jg, dtype=getattr(jnp, dtype))
    got = tgrid.make_render_cache(tg, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (16 ** 3,)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_sample_grid_matches_jax():
    jg, tg = random_grids(16, 4, seed=31)
    pts = np.random.default_rng(32).uniform(-1.1, 1.1, (5, 7, 3)).astype(np.float32)
    wd, ws = jitted(jgrid.sample_grid, jg, jnp.asarray(pts))
    gd, gs = tgrid.sample_grid(tg, torch.from_numpy(pts))
    assert tuple(gd.shape) == (5, 7, 1) and tuple(gs.shape) == (5, 7, 12)
    close(gd, wd)
    close(gs, ws)
    assert tgrid.sample_grid(tg, torch.from_numpy(pts), want_colors=False)[1] is None


@pytest.mark.parametrize("sigma_thresh", [None, 3.0])
def test_volume_render_depth_matches_jax(sigma_thresh):
    """Expected-termination depth, and the Dex-NeRF first crossing (rays
    that never cross read 0)."""
    jg, tg = random_grids(16, 4, seed=33)
    jr, tr = both_rays(random_rays(N_RAYS, seed=34))
    want = jitted(jgrid.volume_render_depth, jg, jr, sigma_thresh=sigma_thresh, static=("sigma_thresh",))
    got = tgrid.volume_render_depth(tg, tr, sigma_thresh=sigma_thresh)
    close(got, want, rtol=1e-5, atol=1e-4)
    if sigma_thresh is not None:
        assert 0 < int((got == 0).sum()) < N_RAYS  # some rays miss, some cross


def test_sh_mult_replaces_the_analytic_basis():
    jg, tg = random_grids(16, 4, seed=35)
    jr, tr = both_rays(random_rays(N_RAYS, seed=36))
    mult = np.random.default_rng(37).uniform(-1.0, 1.0, (N_RAYS, 4)).astype(np.float32)
    got, want = render_both(jg, tg, jr, tr, sh_mult=(jnp.asarray(mult), torch.from_numpy(mult)))
    for k in OUT_KEYS:
        close(got[k], want[k], **TOL)
    plain = tgrid.volume_render_grid(tg, tr)
    assert float((got["rgb"] - plain["rgb"]).abs().max()) > 1e-2


@pytest.mark.parametrize("backend", ["nvol", "svox1"])
@pytest.mark.parametrize("color_mode", ["bias", "sigmoid"])
def test_backends_match_jax(backend, color_mode):
    jg, tg = random_grids(16, 4, seed=38, dens_hi=10.0)
    jr, tr = both_rays(random_rays(N_RAYS, seed=39))
    got, want = render_both(jg, tg, jr, tr, jgrid.GridRenderOptions(backend=backend, color_mode=color_mode),
                            tgrid.GridRenderOptions(backend=backend, color_mode=color_mode), return_depth=True)
    for k in OUT_KEYS + ("depth",):
        close(got[k], want[k], rtol=1e-5, atol=1e-4 if k == "depth" else 1e-5)


def test_svox1_rounds_half_to_even_as_jax():
    """Rays whose samples lie exactly on .5 in x and y (grid coordinates
    7.5 and 6.5): jnp.round and torch.round both round half to even, so
    both read cells 8 and 6, where rounding half up would read 8 and 7."""
    jg, tg = random_grids(16, 4, seed=40, dens_hi=10.0)
    o, d, v = random_rays(N_RAYS, seed=41)
    o[:2] = [[0.0, -0.125, -2.0], [0.0, -0.125, 2.0]]
    d[:2] = v[:2] = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]
    np.testing.assert_array_equal(np_(tg.world_to_grid(torch.from_numpy(o[:2]))[:, :2]), [[7.5, 6.5], [7.5, 6.5]])
    jr, tr = both_rays([o, d, v])
    opts = dict(backend="svox1", step_size=0.5)
    got, want = render_both(jg, tg, jr, tr, jgrid.GridRenderOptions(**opts), tgrid.GridRenderOptions(**opts))
    for k in OUT_KEYS:
        close(got[k], want[k], **TOL)
    # the cells read: x 8, y 6 along the whole ray
    line = np_(tg.density_data)[np.maximum(np_(tg.links)[8, 6, :], 0), 0] * (np_(tg.links)[8, 6, :] >= 0)
    assert np.isin(np_(got["sigma"])[0][np_(got["sigma"])[0] > 0], line).all()


def nonzero_weights(tg, tr, **kw):
    return int((tgrid.volume_render_grid(tg, tr, **kw)["weights"] > 0).sum(-1).max())


@pytest.mark.parametrize("cache", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("k", ["below", "above"])
def test_top_k_matches_jax(cache, k):
    """K below the rays' count of nonzero weights, and at or above it (the
    route is then exact: its rgb equals the exact render's). Ties are
    zero weights, which add nothing, so outputs are compared, not
    indices."""
    jg, tg = random_grids(16, 4, seed=41, dens_hi=2.0)
    jr, tr = both_rays(random_rays(N_RAYS, seed=42))
    n_nz = nonzero_weights(tg, tr)
    K = max(n_nz // 3, 1) if k == "below" else n_nz
    kw = dict(color_top_k=K)
    if cache is not None:
        kw["dense_density"] = (jgrid.make_render_cache(jg, getattr(jnp, cache)),
                               tgrid.make_render_cache(tg, getattr(torch, cache)))
    got, want = render_both(jg, tg, jr, tr, return_depth=True, **kw)
    for key in OUT_KEYS + ("depth",):
        close(got[key], want[key], rtol=1e-5, atol=1e-4 if key == "depth" else 1e-5)
    exact = tgrid.volume_render_grid(tg, tr)
    gap = float((exact["rgb"] - got["rgb"]).abs().max())
    if k == "above" and cache != "bfloat16":
        assert gap < 1e-5
    elif k == "below":
        assert gap > 1e-3


@pytest.mark.parametrize("occupancy", [False, True])
def test_top_k_with_occupancy_matches_jax(occupancy):
    """The CLI's fast keywords together: occupancy with 256 active steps,
    top-48 colour and the bf16 cache."""
    jg, tg = random_grids(16, 4, seed=43)
    jr, tr = both_rays(random_rays(N_RAYS, seed=44))
    kw = dict(color_top_k=48, dense_density=(jgrid.make_render_cache(jg, jnp.bfloat16),
                                             tgrid.make_render_cache(tg, torch.bfloat16)))
    if occupancy:
        kw.update(occupancy=(jacc.build_occupancy(jg, factor=8), tacc.build_occupancy(tg, factor=8)),
                  active_steps=256)
    got, want = render_both(jg, tg, jr, tr, **kw)
    for key in OUT_KEYS:
        close(got[key], want[key], **TOL)


def random_msi(seed, nlayers=4, reso=8, inner_radius=3.0):
    rng = np.random.default_rng(seed)
    jm = jbgm.BackgroundMSI.create(nlayers, reso, inner_radius=inner_radius)
    data = rng.normal(0.0, 1.0, np.asarray(jm.data).shape).astype(np.float32)
    data[..., 3] = rng.uniform(0.0, 2.0, data.shape[:-1])
    return jm._replace(data=jnp.asarray(data)), tbgm.BackgroundMSI.from_numpy(data, jm.radii, device="cpu")


def random_reference_bg(seed, nlayers=4, reso=8):
    rng = np.random.default_rng(seed)
    links = rng.permutation(2 * reso * reso).reshape(2 * reso, reso).astype(np.int32)
    links[rng.uniform(size=links.shape) < 0.2] = -1  # pruned texels
    data = rng.normal(0.0, 1.0, (2 * reso * reso, nlayers, 4)).astype(np.float32)
    data[..., 3] = rng.uniform(0.0, 3.0, data.shape[:-1])
    return (jbgm.ReferenceBackground(jnp.asarray(data), jnp.asarray(links)),
            tbgm.ReferenceBackground.from_numpy(data, links, device="cpu"))


@pytest.mark.parametrize("kind", ["msi", "reference"])
@pytest.mark.parametrize("top_k", [None, 12])
def test_backgrounds_composited_match_jax(kind, top_k):
    jg, tg = random_grids(16, 4, seed=45, dens_hi=1.0)
    o, d, v = random_rays(N_RAYS, seed=46)
    d = v  # unit directions, as the reference background assumes
    jr, tr = both_rays([o, d, v])
    bgs = random_msi(47) if kind == "msi" else random_reference_bg(48)
    got, want = render_both(jg, tg, jr, tr, background=bgs, color_top_k=top_k)
    for key in OUT_KEYS:
        close(got[key], want[key], **TOL)
    solid = tgrid.volume_render_grid(tg, tr, color_top_k=top_k)
    assert float((got["rgb"] - solid["rgb"]).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# The render CLI's default route
# ---------------------------------------------------------------------------

SIZE = 24


@pytest.fixture(scope="module")
def scene_and_grid(tmp_path_factory):
    """The fixture of tests/test_torch_render_imgs.py."""
    root = str(tmp_path_factory.mktemp("blender"))
    make_blender_scene(root)
    rng = np.random.default_rng(1)
    jg = JaxSparseGrid.create(16, basis_dim=4, use_sphere_bound=True)
    dens = rng.uniform(0.0, 8.0, (jg.capacity, 1)).astype(np.float32)
    sh = (rng.standard_normal((jg.capacity, 12)) * 0.3).astype(np.float16).astype(np.float32)
    jg = replace(jg, density_data=jnp.asarray(dens), sh_data=jnp.asarray(sh))
    ckpt = os.path.join(root, "grid.npz")
    jg.save(ckpt)
    return root, ckpt


def test_render_grid_image_fast_keywords_match_jax(scene_and_grid):
    root, ckpt = scene_and_grid
    jg, tg = JaxSparseGrid.load(ckpt), SparseGrid.load(ckpt, device="cpu")
    jfast = dict(occupancy=jacc.build_occupancy(jg, factor=8, sigma_thresh=1e-8), color_top_k=48,
                 dense_density=jgrid.make_render_cache(jg, dtype=jnp.bfloat16))
    tfast = dict(occupancy=tacc.build_occupancy(tg, factor=8, sigma_thresh=1e-8), color_top_k=48,
                 dense_density=tgrid.make_render_cache(tg, dtype=torch.bfloat16))
    want = jri.render_grid_image(jg, jax_load_scene(root, "test"), 1, jgrid.GridRenderOptions(), chunk=SIZE * SIZE,
                                 **jfast)
    got = tri.render_grid_image(tg, load_scene(root, "test"), 1, tgrid.GridRenderOptions(), chunk=100, **tfast)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


def test_cli_default_route_matches_the_jax_cli(scene_and_grid, tmp_path, capsys):
    """main() with no route flag is the fast route, as in JAX: the same
    metrics as the JAX CLI's default run, and different from --exact."""
    root, ckpt = scene_and_grid
    jri.main([ckpt, root, "--n_images", "2", "--chunk", str(SIZE * SIZE)])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tri.main([ckpt, root, "--device", "cpu", "--n_images", "2", "--out_dir", str(tmp_path / "fast")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.isfile(tmp_path / "fast" / "0001.png")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
    tri.main([ckpt, root, "--device", "cpu", "--n_images", "2", "--exact"])
    exact = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert exact["psnr"] != got["psnr"]
    tri.main([ckpt, root, "--device", "cpu", "--n_images", "1", "--no_fallback", "--color_top_k", "8", "--timing"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["fps"] > 0
