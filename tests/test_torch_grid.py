"""The port's Plenoxels grid modules against the JAX package (CPU): SH
bases, the sparse grid and its npz round trip, brick grids, trilinear
interpolation, the exact volume render, occupancy, OpenCV camera rays.

Inputs come from seeded numpy and go to both sides. Float32 on both
sides, so the tolerances are float32 ones (1e-5, or 1e-5 relative to a
quantity's scale), differing in summation order only."""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.core.rays import Rays as JaxRays
from nerf_projects_tpu.core.rays import camera_rays_opencv as jax_camera_rays_opencv
from nerf_projects_tpu.models.sparse_grid import SparseGrid as JaxSparseGrid
from nerf_projects_tpu.ops import brick_grid as jbg
from nerf_projects_tpu.ops import grid as jgrid
from nerf_projects_tpu.ops import grid_accel as jacc
from nerf_projects_tpu.ops import sh as jsh
from nerf_projects_tpu_torch.core.rays import Rays, camera_rays_opencv
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.ops import brick_grid as tbg
from nerf_projects_tpu_torch.ops import grid as tgrid
from nerf_projects_tpu_torch.ops import grid_accel as tacc
from nerf_projects_tpu_torch.ops import sh as tsh

TOL = dict(rtol=1e-5, atol=1e-5)


def random_grids(reso=16, basis_dim=9, seed=0, dens_hi=6.0):
    """The same random sphere-bound grid on both sides."""
    rng = np.random.default_rng(seed)
    jg = JaxSparseGrid.create(reso, basis_dim=basis_dim, use_sphere_bound=True)
    dens = rng.uniform(0.0, dens_hi, (jg.capacity, 1)).astype(np.float32)
    sh = (rng.standard_normal((jg.capacity, 3 * basis_dim)) * 0.3).astype(np.float32)
    jg = replace(jg, density_data=jnp.asarray(dens), sh_data=jnp.asarray(sh))
    tg = SparseGrid.from_numpy(np.asarray(jg.links), dens, sh, jg.radius, jg.center, basis_dim, device="cpu")
    return jg, tg


def random_rays(n=48, seed=1):
    """Rays from a sphere of radius 2.5 towards the grid, some grazing."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 2.5 + 0.35 * rng.standard_normal((n, 3))
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return [x.astype(np.float32) for x in (o, d * 1.3, vd)]


def both_rays(arrays):
    return JaxRays(*(jnp.asarray(a) for a in arrays)), Rays(*(torch.from_numpy(a) for a in arrays))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# SH
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("basis_dim", [1, 4, 9, 16, 25, 7])
def test_eval_sh_bases_matches_jax(basis_dim):
    rng = np.random.default_rng(basis_dim)
    d = rng.standard_normal((5, 7, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    close(tsh.eval_sh_bases(basis_dim, torch.from_numpy(d)), jsh.eval_sh_bases(basis_dim, jnp.asarray(d)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(10 + deg)
    d = rng.standard_normal((11, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = rng.standard_normal((11, 3, (deg + 1) ** 2)).astype(np.float32)
    close(tsh.eval_sh(deg, torch.from_numpy(c), torch.from_numpy(d)), jsh.eval_sh(deg, jnp.asarray(c), jnp.asarray(d)))
    with pytest.raises(ValueError):
        tsh.eval_sh(deg, torch.from_numpy(c[..., :1] if deg else np.zeros((11, 3, 2), np.float32)),
                    torch.from_numpy(d))


# ---------------------------------------------------------------------------
# Sparse grid, brick grid, persistence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(use_sphere_bound=True), dict(use_sphere_bound=False, use_z_order=False),
                                dict(use_sphere_bound=True, radius=1.5, center=(0.1, -0.2, 0.3))])
def test_sparse_grid_create_and_transforms_match_jax(kw):
    jg = JaxSparseGrid.create((12, 16, 8), basis_dim=4, init_density=0.3, **kw)
    tg = SparseGrid.create((12, 16, 8), basis_dim=4, init_density=0.3, device="cpu", **kw)
    np.testing.assert_array_equal(tg.links.numpy(), np.asarray(jg.links))
    close(tg.density_data, jg.density_data)
    assert tg.sh_data.shape == jg.sh_data.shape and tg.reso == jg.reso
    pts = np.random.default_rng(0).uniform(-2, 2, (20, 3)).astype(np.float32)
    close(tg.world_to_grid(torch.from_numpy(pts)), jg.world_to_grid(jnp.asarray(pts)))
    close(tg.grid_to_world(tg.world_to_grid(torch.from_numpy(pts))), pts, rtol=1e-5, atol=1e-5)


def test_brick_grid_conversions_match_jax():
    jg, tg = random_grids(20, 4, seed=3)  # 20 is not brick-aligned: padded bricks
    jb, tb = jbg.from_sparse_grid(jg), tbg.from_sparse_grid(tg)
    np.testing.assert_array_equal(tb.brick_links.numpy(), np.asarray(jb.brick_links))
    np.testing.assert_array_equal(tb.cell_mask.numpy(), np.asarray(jb.cell_mask))
    np.testing.assert_array_equal(tb.brick_coords.numpy(), np.asarray(jb.brick_coords))
    close(tb.density_bricks, jb.density_bricks, rtol=0, atol=0)
    close(tb.sh_bricks, jb.sh_bricks, rtol=0, atol=0)
    back = tbg.to_sparse_grid(tb)
    jback = jbg.to_sparse_grid(jb)
    np.testing.assert_array_equal(back.links.numpy(), np.asarray(jback.links))
    close(back.density_data, jback.density_data, rtol=0, atol=0)
    close(back.sh_data, jback.sh_data, rtol=0, atol=0)


@pytest.mark.parametrize("sphere", [True, False])
def test_create_brick_grid_matches_jax(sphere):
    jb = jbg.create_brick_grid(32, basis_dim=4, use_sphere_bound=sphere, init_density=0.2)
    tb = tbg.create_brick_grid(32, basis_dim=4, use_sphere_bound=sphere, init_density=0.2, device="cpu")
    np.testing.assert_array_equal(tb.brick_links.numpy(), np.asarray(jb.brick_links))
    np.testing.assert_array_equal(tb.cell_mask.numpy(), np.asarray(jb.cell_mask))
    close(tb.density_bricks, jb.density_bricks, rtol=0, atol=0)
    assert tuple(tb.sh_bricks.shape) == tuple(jb.sh_bricks.shape)
    slim = tbg.create_brick_grid(32, basis_dim=4, alloc_data=False, device="cpu")
    assert slim.n_bricks == tb.n_bricks and slim.density_bricks.numel() == tb.n_bricks
    with pytest.raises(ValueError, match="brick-aligned"):
        tbg.create_brick_grid(20, device="cpu")


def test_grid_saved_by_jax_loads_in_the_port_and_renders_the_same(tmp_path):
    """Weights carried across: JAX SparseGrid.save -> the port's load ->
    the exact render equals the JAX render of the JAX-loaded grid (the
    npz stores SH as float16 on both sides); and the port's save loads
    back in JAX unchanged."""
    jg, _ = random_grids(16, 9, seed=5)
    path = str(tmp_path / "grid.npz")
    jg.save(path)
    tg = SparseGrid.load(path, device="cpu")
    jl = JaxSparseGrid.load(path)
    assert tg.basis_dim == 9 and tg.reso == jl.reso
    close(tg.sh_data, jl.sh_data, rtol=0, atol=0)
    jr, tr = both_rays(random_rays(40, seed=6))
    opts = jgrid.GridRenderOptions()
    want = jgrid.volume_render_grid(jl, jr, opts, return_depth=True)
    got = tgrid.volume_render_grid(tg, tr, tgrid.GridRenderOptions(), return_depth=True)
    for k in ("rgb", "acc", "depth", "log_transmit"):
        close(got[k], want[k], rtol=1e-5, atol=1e-5)
    path2 = str(tmp_path / "port.npz")
    tg.save(path2)
    again = JaxSparseGrid.load(path2)
    np.testing.assert_array_equal(np.asarray(again.links), np.asarray(jl.links))
    close(np.asarray(again.sh_data), jl.sh_data, rtol=0, atol=0)
    close(np.asarray(again.density_data), jl.density_data, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Interpolation and the exact render
# ---------------------------------------------------------------------------

def test_trilerp_matches_jax_including_the_faces():
    """Random points, points on the upper faces (x = reso - 1: the upper
    tap has weight 0 and nothing past the grid is read) and points just
    outside (clamped)."""
    jg, tg = random_grids(16, 4, seed=7)
    rng = np.random.default_rng(8)
    pts = rng.uniform(-0.5, 15.5, (64, 3)).astype(np.float32)
    pts[:8, 0] = 15.0
    pts[8:16, 1] = 15.0
    pts[16:24] = 15.0
    pts[24:28, 2] = 0.0
    for data in ("density_data", "sh_data"):
        close(tgrid.trilerp(tg, getattr(tg, data), torch.from_numpy(pts)),
              jgrid.trilerp(jg, getattr(jg, data), jnp.asarray(pts)))


@pytest.mark.parametrize("opts_kw", [
    dict(),
    dict(step_size=0.7, near_clip=0.4, background_brightness=0.0),
    dict(color_mode="sigmoid", stop_thresh=1e-3),
])
def test_volume_render_grid_matches_jax(opts_kw):
    jg, tg = random_grids(16, 9, seed=11, dens_hi=20.0)
    jr, tr = both_rays(random_rays(48, seed=12))
    want = jgrid.volume_render_grid(jg, jr, jgrid.GridRenderOptions(**opts_kw), return_depth=True)
    got = tgrid.volume_render_grid(tg, tr, tgrid.GridRenderOptions(**opts_kw), return_depth=True)
    for k in ("rgb", "acc", "depth", "log_transmit", "weights", "sigma"):
        close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_volume_render_grid_with_occupancy_matches_jax():
    jg, tg = random_grids(16, 4, seed=13)
    jocc = jacc.build_occupancy(jg, factor=4)
    tocc = tacc.build_occupancy(tg, factor=4)
    np.testing.assert_array_equal(tocc.bitmap.numpy(), np.asarray(jocc.bitmap))
    jr, tr = both_rays(random_rays(32, seed=14))
    want = jgrid.volume_render_grid(jg, jr, jgrid.GridRenderOptions(), occupancy=jocc, active_steps=40)
    got = tgrid.volume_render_grid(tg, tr, tgrid.GridRenderOptions(), occupancy=tocc, active_steps=40)
    for k in ("rgb", "acc", "log_transmit"):
        close(got[k], want[k], rtol=1e-5, atol=1e-5)
    want = jgrid.volume_render_grid(jg, jr, jgrid.GridRenderOptions(backend="nvol"), occupancy=jocc, active_steps=40)
    got = tgrid.volume_render_grid(tg, tr, tgrid.GridRenderOptions(backend="nvol"), occupancy=tocc, active_steps=40)
    for k in ("rgb", "acc", "log_transmit"):
        close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_occupancy_intervals_match_jax():
    """occupied_aabb, aabb_t_range and active_t_range on a grid whose
    occupancy covers only part of the box."""
    jg, tg = random_grids(32, 1, seed=15)
    links = np.asarray(jg.links).copy()
    links[:12] = -1
    links[:, 20:] = -1
    jg = replace(jg, links=jnp.asarray(links))
    tg.links = torch.from_numpy(links)
    jocc, tocc = jacc.build_occupancy(jg), tacc.build_occupancy(tg)
    for g, w in zip(tacc.occupied_aabb(tocc), jacc.occupied_aabb(jocc)):
        close(g, w, rtol=0, atol=0)
    o, d, _ = random_rays(40, seed=16)
    og = np.array(jg.world_to_grid(jnp.asarray(o)))
    dg = (d * 16.0).astype(np.float32)
    t0 = np.zeros(40, np.float32)
    t1 = np.full(40, 0.2, np.float32)
    for name in ("aabb_t_range", "active_t_range"):
        want = getattr(jacc, name)(jocc, *(jnp.asarray(a) for a in (og, dg, t0, t1)))
        got = getattr(tacc, name)(tocc, *(torch.from_numpy(a) for a in (og, dg, t0, t1)))
        for g, w in zip(got, want):
            close(g, w, rtol=1e-5, atol=1e-6)


def test_camera_rays_opencv_matches_jax():
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(np.random.default_rng(17).standard_normal((3, 3)))[0]
    c2w[:3, 3] = [0.3, -0.2, 2.4]
    want = jax_camera_rays_opencv(6, 10, 9.0, 8.5, 5.0, 3.0, jnp.asarray(c2w))
    got = camera_rays_opencv(6, 10, 9.0, 8.5, 5.0, 3.0, c2w, device="cpu")
    for g, w in zip(got, want):
        close(g, w, rtol=1e-6, atol=1e-6)


def test_grid_entry_points_default_to_the_card(monkeypatch):
    """device=None means cuda: without a card the constructors raise
    instead of building on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: SparseGrid.create(8), lambda: tbg.create_brick_grid(16),
                 lambda: camera_rays_opencv(2, 2, 1.0, 1.0, 1.0, 1.0, np.eye(4))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
