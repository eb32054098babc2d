"""The port's tile march (K3) on the CPU, through its plain PyTorch
version, against the JAX package: its Pallas kernel (interpret mode), its
jnp twin (``ops/tile_render.py::render_tiles``) and its exact per-ray
render (``ops/grid.py::volume_render_grid``).

The TPU march reads 2x2x2-brick windows and drops the samples that fall
outside them; the port reads every sample. So the port is compared with
the TPU march only on rays where that march missed nothing, and with the
exact render everywhere the two sample the same points (one-ray tiles,
or tiles whose rays all start at one origin, with basis_dim 1 so that the
tile's basis is the ray's). Grid values are rounded to bf16 first, so the
port's bf16 cells hold them exactly."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_projects_tpu.ops.pallas.tile_march as jtm
from nerf_projects_tpu.core.rays import Rays as JaxRays
from nerf_projects_tpu.models.sparse_grid import SparseGrid as JaxSparseGrid
from nerf_projects_tpu.ops import brick_grid as jbg
from nerf_projects_tpu.ops import grid as jgrid
from nerf_projects_tpu.ops import tile_render as jtr
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.ops import brick_grid as tbg
from nerf_projects_tpu_torch.ops import grid as tgrid
from nerf_projects_tpu_torch.ops import tile_render as ttr
from nerf_projects_tpu_torch.ops.kernels import tile_march as ttm
from nerf_projects_tpu_torch.ops.kernels.frame_march import render_frame_pallas

# the JAX package's own K3-vs-twin tolerances (tests/test_tile_march_pallas.py)
K3_TOL = {"rgb": 2e-2, "acc": 2e-2, "depth": 5e-2, "log_transmit": 3e-2, "sparsity_sum": 3e-2}
F32_TOL = 1e-4


def bf16_exact(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def random_grids(reso=32, basis_dim=9, seed=0, dens_hi=6.0, sphere=True):
    rng = np.random.default_rng(seed)
    jg = JaxSparseGrid.create(reso, basis_dim=basis_dim, use_sphere_bound=sphere)
    dens = bf16_exact(rng.uniform(0.0, dens_hi, (jg.capacity, 1)))
    sh = bf16_exact(rng.standard_normal((jg.capacity, 3 * basis_dim)) * 0.3)
    jg = replace(jg, density_data=jnp.asarray(dens), sh_data=jnp.asarray(sh))
    tg = SparseGrid.from_numpy(np.asarray(jg.links), dens, sh, jg.radius, jg.center, basis_dim, device="cpu")
    return jg, tg


def march_counts(bg, rays, opts, early_stop):
    """The plain march's counts on these tiles: samples marched a ray and
    the touched-brick mask."""
    pack, basis = ttm.pack_rays(bg, rays, opts)
    out, counts = ttm.march_reference(ttm.build_kernel_arrays(bg), bg.brick_links, bg.reso, pack, basis,
                                      max_steps=ttm.default_chunks_for(bg, opts) * ttm.SC,
                                      early_stop=early_stop, counts=True)
    return np_(counts["marched"]), np_(counts["touched"])


def tile_rays(n_tiles, th, tw, seed):
    """Coherent perspective tiles of th x tw rays from cameras at radius
    2.5 (the construction of tests/test_tile_march_pallas.py)."""
    rng = np.random.default_rng(seed)
    os_, ds = [], []
    for _ in range(n_tiles):
        u = rng.standard_normal(3)
        cam = 2.5 * u / np.linalg.norm(u)
        fwd = -cam / 2.5
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right) + 1e-9
        up2 = np.cross(right, fwd)
        jj, ii = np.meshgrid(np.arange(float(tw)), np.arange(float(th)))
        base = rng.uniform(-40, 40, 2)
        d = (fwd[None] + ((base[0] + jj.ravel()) / 200.0)[:, None] * right[None]
             + ((base[1] + ii.ravel()) / 200.0)[:, None] * up2[None])
        ds.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
        os_.append(np.tile(cam[None], (th * tw, 1)))
    o, d = (np.stack(x).astype(np.float32) for x in (os_, ds))
    return [o, d, d]


def both(arrays):
    return JaxRays(*(jnp.asarray(a) for a in arrays)), Rays(*(torch.from_numpy(a) for a in arrays))


def f32_twin(*args, **kw):
    """The JAX twin with its bf16 products lifted to float32 (the twin
    rounds the hat weights and the window to bf16 before the x-stage
    contraction; with float32 there it is an exact trilinear march)."""
    old = jnp.bfloat16
    jnp.bfloat16 = jnp.float32
    try:
        return jtr.render_tiles(*args, **kw)
    finally:
        jnp.bfloat16 = old


def twin_miss_per_ray(jb, jr, opts, Sc):
    """Per ray, the in-span samples that the twin's window plan (a
    window on each chunk's valid-sample centroid) leaves outside the
    exact [0, 15] window span: render_tiles' own plan and test, per ray
    instead of summed."""
    T, R = jr.origins.shape[:2]
    C = jtr.default_chunks(jb, opts.step_size, Sc)
    reso = jnp.asarray(jb.reso, jnp.float32)
    og = jb.world_to_grid(jr.origins)
    dg = jr.directions * (reso * 0.5 / jnp.asarray(jb.radius))
    world_len = jnp.linalg.norm(jr.directions, axis=-1)
    dt = opts.step_size / jnp.maximum(jnp.linalg.norm(dg, axis=-1), 1e-12)
    inv_d = 1.0 / jnp.where(jnp.abs(dg) < 1e-12, 1e-12, dg)
    t_lo, t_hi = (0.0 - og) * inv_d, (reso - 1.0 - og) * inv_d
    t0 = jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
    t1 = jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
    t0 = jnp.maximum(t0, opts.near_clip / jnp.maximum(world_len, 1e-12))
    hit = t1 > t0
    T0 = jnp.min(jnp.where(hit, t0, 1e30), axis=-1)
    T0 = jnp.where(T0 < 1e30, T0, 0.0)
    Bm2 = jnp.asarray([b - 2 for b in jb.bricks_shape])
    miss = jnp.zeros((T, R))
    for c in range(C):
        t = T0[:, None, None] + (c * Sc + jnp.arange(Sc, dtype=jnp.float32)) * dt[..., None]
        valid = (t >= t0[..., None]) & (t < t1[..., None]) & hit[..., None]
        pos = og[:, :, None, :] + t[..., None] * dg[:, :, None, :]
        vw = valid[..., None].astype(jnp.float32)
        centroid = jnp.sum(pos * vw, axis=(1, 2)) / jnp.maximum(jnp.sum(vw, axis=(1, 2)), 1.0)
        wb = jnp.clip(jnp.round(centroid / 8 - 1.0).astype(jnp.int32), 0, Bm2)
        local = pos - (wb[:, None, None, :] * 8).astype(jnp.float32)
        in_exact = jnp.all((local >= 0.0) & (local <= 15.0), axis=-1)
        miss = miss + jnp.sum((valid & ~in_exact).astype(jnp.float32), axis=-1)
    return np.asarray(miss)


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module", params=[(8, 16), (16, 16)], ids=["r128", "r256"])
def coherent(request):
    """Two coherent tiles on a 32^3 grid through JAX's K3 (interpret mode)
    and twin, and through the port's plain K3 (bf16 cells) and
    render_tiles (float32 cells)."""
    th, tw = request.param
    jg, tg = random_grids(32, 9, seed=th)
    jb, tb = jbg.from_sparse_grid(jg), tbg.from_sparse_grid(tg)
    jr, tr = both(tile_rays(2, th, tw, seed=tw + 1))
    opts_j, opts_t = jgrid.GridRenderOptions(step_size=0.5), tgrid.GridRenderOptions(step_size=0.5)
    old = jtm.INTERPRET
    jtm.INTERPRET = True
    try:
        k3 = jtm.render_tiles_pallas(jb, jr, opts_j, return_depth=True)
    finally:
        jtm.INTERPRET = old
    return dict(
        k3=jax.tree_util.tree_map(np.asarray, k3),
        twin_miss=twin_miss_per_ray(jb, jr, opts_j, jtm.SC),
        twin=jtr.render_tiles(jb, jr, opts_j, steps_per_chunk=jtm.SC, return_depth=True),
        twin32=f32_twin(jb, jr, opts_j, steps_per_chunk=jtm.SC, return_depth=True),
        port=ttm.render_tiles_pallas(tb, tr, opts_t, return_depth=True),
        port32=ttr.render_tiles(tb, tr, opts_t, steps_per_chunk=ttm.SC, return_depth=True),
        bg=tb, rays=tr,
    )


def assert_close_on(got, want, keep, tols, what):
    for k, tol in tols.items():
        g, w = np_(got[k])[keep], np_(want[k])[keep]
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"{what}: {k}")


def test_plain_k3_matches_jax_k3_on_rays_without_misses(coherent):
    miss = coherent["k3"]["miss_per_ray"]
    keep = miss == 0
    assert keep.mean() >= 0.95, keep.mean()
    assert_close_on(coherent["port"], coherent["k3"], keep, K3_TOL, "port plain K3 vs JAX K3")
    assert float(coherent["port"]["window_miss"]) == 0.0
    assert not np_(coherent["port"]["miss_per_ray"]).any()


def test_plain_k3_matches_jax_twin(coherent):
    keep = coherent["k3"]["miss_per_ray"] == 0
    assert_close_on(coherent["port"], coherent["twin"], keep, K3_TOL, "port plain K3 vs JAX twin")


def test_float32_render_tiles_matches_the_float32_twin(coherent):
    """With float32 on both sides the tiles march the same samples with
    the same basis: 1e-4 on the rays that the twin's own window plan
    misses nothing of."""
    assert float(coherent["twin32"]["window_miss"]) > 0.0  # so the mask below matters
    keep = coherent["twin_miss"] == 0
    assert keep.mean() >= 0.95, keep.mean()
    tols = {k: F32_TOL for k in K3_TOL}
    assert_close_on(coherent["port32"], coherent["twin32"], keep, tols, "port render_tiles vs f32 twin")
    # bf16 cells hold the (bf16-exact) grid values exactly
    assert_close_on(coherent["port"], coherent["port32"], np.ones_like(keep), tols, "bf16 vs f32 cells")


def test_frame_path_equals_the_tile_path_and_early_stop_changes_no_pixel(coherent):
    bg, rays = coherent["bg"], coherent["rays"]
    opts = tgrid.GridRenderOptions(step_size=0.5)
    ka = ttm.build_kernel_arrays(bg)
    frame = render_frame_pallas(ttm.geometry_only(bg), rays, opts, kernel_arrays=ka, use_occupancy=False,
                                return_depth=True)
    tiles = coherent["port"]
    for k in ("rgb", "acc", "log_transmit", "depth"):
        np.testing.assert_array_equal(np_(frame[k]), np_(tiles[k]), err_msg=k)
    stop = ttm.render_tiles_pallas(bg, rays, opts, early_stop=True)
    marched_stop, touched_stop = march_counts(bg, rays, opts, early_stop=True)
    marched, touched = march_counts(bg, rays, opts, early_stop=False)
    assert (marched_stop <= marched).all() and marched.sum() > 0
    assert not (touched_stop & ~touched).any() and touched.any()
    assert (np_(stop["sparsity_sum"]) <= np_(tiles["sparsity_sum"]) + 1e-6).all()
    with pytest.raises(NotImplementedError, match="max_windows"):
        render_frame_pallas(bg, rays, opts, kernel_arrays=ka, max_windows=2)


def test_early_stop_on_an_opaque_grid():
    """Dense grid (tau ~ 10 a sample): rays stop within a few samples;
    rgb, acc, depth and log_transmit stay bit-identical, the sparsity sum
    and the samples counted stop with the ray."""
    _, tg = random_grids(16, 4, seed=3, dens_hi=4000.0)
    bg = tbg.from_sparse_grid(tg)
    _, rays = both(tile_rays(2, 8, 16, seed=4))
    opts = tgrid.GridRenderOptions()
    full = ttm.render_tiles_pallas(bg, rays, opts, return_depth=True)
    stop = ttm.render_tiles_pallas(bg, rays, opts, return_depth=True, early_stop=True)
    for k in ("rgb", "acc", "log_transmit", "depth"):
        np.testing.assert_array_equal(np_(stop[k]), np_(full[k]), err_msg=k)
    hit = np_(full["acc"]) > 0.99
    assert hit.mean() > 0.5
    marched_stop, touched_stop = march_counts(bg, rays, opts, early_stop=True)
    marched, touched = march_counts(bg, rays, opts, early_stop=False)
    assert (marched_stop[hit] < marched[hit]).all()
    assert touched_stop.sum() < touched.sum()
    assert (np_(stop["sparsity_sum"])[hit] < np_(full["sparsity_sum"])[hit]).all()


def test_any_tile_size_matches_the_float32_twin():
    """512-ray tiles (16 x 32, the frame bench's) and 32-ray tiles, which
    the TPU kernel does not take, against the f32 twin (any R)."""
    jg, tg = random_grids(16, 4, seed=21)
    jb, tb = jbg.from_sparse_grid(jg), tbg.from_sparse_grid(tg)
    for th, tw in ((16, 32), (4, 8)):
        jr, tr = both(tile_rays(1, th, tw, seed=th))
        want = f32_twin(jb, jr, jgrid.GridRenderOptions(), steps_per_chunk=ttm.SC)
        got = ttm.render_tiles_pallas(tb, tr, tgrid.GridRenderOptions())
        assert float(want["window_miss"]) == 0.0
        for k in ("rgb", "acc", "log_transmit", "sparsity_sum"):
            np.testing.assert_allclose(np_(got[k]), np_(want[k]), rtol=F32_TOL, atol=F32_TOL, err_msg=k)


def test_incoherent_tile_matches_the_exact_render_where_jax_misses():
    """Rays from the grid centre in random directions cannot share a
    window: JAX's twin drops samples (window_miss > 0.01). All origins
    at 0 put every entry at t0 = 0 = T0 and basis_dim 1 makes the tile
    basis the ray's, so the port's march must equal the exact per-ray
    render on every ray, and report no miss."""
    jg, tg = random_grids(32, 1, seed=0)
    rng = np.random.default_rng(0)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((64, 3), np.float32)
    jr, tr = both([o[None], d[None], d[None]])
    opts_j, opts_t = jgrid.GridRenderOptions(), tgrid.GridRenderOptions()
    assert float(jtr.render_tiles(jbg.from_sparse_grid(jg), jr, opts_j)["window_miss"]) > 0.01
    got = ttm.render_tiles_pallas(tbg.from_sparse_grid(tg), tr, opts_t, return_depth=True)
    want = jgrid.volume_render_grid(jg, JaxRays(*(x[0] for x in jr)), opts_j, return_depth=True)
    for k in ("rgb", "acc", "log_transmit", "depth"):
        np.testing.assert_allclose(np_(got[k])[0], np_(want[k]), rtol=F32_TOL, atol=F32_TOL, err_msg=k)
    assert float(got["window_miss"]) == 0.0 and not np_(got["miss_per_ray"]).any()


def one_ray_tiles_vs_exact(tg, o, d, **opts_kw):
    """Tiles of one ray march from the ray's own entry with its own
    basis (basis_dim 1): the port's march equals the exact render."""
    opts = tgrid.GridRenderOptions(**opts_kw)
    rays = Rays(*(torch.from_numpy(x)[:, None] for x in (o, d, d)))
    got = ttm.render_tiles_pallas(tbg.from_sparse_grid(tg), rays, opts, return_depth=True)
    want = tgrid.volume_render_grid(tg, Rays(*(torch.from_numpy(x) for x in (o, d, d))), opts,
                                    return_depth=True)
    for k in ("rgb", "acc", "log_transmit", "depth"):
        np.testing.assert_allclose(np_(got[k])[:, 0], np_(want[k]), rtol=F32_TOL, atol=F32_TOL, err_msg=k)
    return got


def test_samples_on_the_upper_faces_read_no_further_than_the_grid():
    """Rays entering through the upper faces (x, y or z = reso - 1) take
    their first sample on the face; a full grid with data on the faces
    renders as the exact path does (which clamps the lower corner to
    reso - 2)."""
    _, tg = random_grids(16, 1, seed=5, sphere=False)
    o = np.array([[2.0, 0.1, 0.2], [0.13, 2.0, -0.1], [0.2, -0.3, 2.0], [1.7, 1.9, 1.8]], np.float32)
    d = np.array([[-1.0, 0.02, 0.01], [0.01, -1.0, 0.03], [0.0, 0.01, -1.0], [-1.0, -1.1, -0.9]], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = one_ray_tiles_vs_exact(tg, o, d)
    assert (np_(got["acc"]) > 0.5).all()


def test_a_sample_beside_an_occupied_brick_reads_it():
    """Only brick (1, 1, 1) holds data. A ray along y at x = 7.5 lies in
    the empty brick 0 in x, yet every sample's upper x tap is in the
    occupied brick: it must read half its density, as the exact path."""
    g = SparseGrid.create(32, basis_dim=1, init_density=0.0, device="cpu")
    links = g.links.numpy()
    keep = np.zeros_like(links, bool)
    keep[8:16, 8:16, 8:16] = True
    rows = links[keep]
    g.density_data[rows.astype(np.int64)] = 3.0
    g.sh_data[rows.astype(np.int64)] = 0.4
    g.links = torch.from_numpy(np.where(keep, links, -1).astype(np.int32))
    # grid x = 7.5 and z = 10.5 in world units (reso 32, radius 1)
    o = np.array([[(7.5 + 0.5) / 16 - 1, -1.5, (10.5 + 0.5) / 16 - 1]], np.float32)
    d = np.array([[0.0, 1.0, 0.0]], np.float32)
    got = one_ray_tiles_vs_exact(g, o, d)
    assert float(got["acc"][0, 0]) > 0.1


def test_random_one_ray_tiles_match_the_exact_render():
    _, tg = random_grids(16, 1, seed=9, dens_hi=20.0)
    rng = np.random.default_rng(10)
    o = rng.standard_normal((24, 3))
    o = (2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = (-o / 2.5 + 0.3 * rng.standard_normal((24, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    one_ray_tiles_vs_exact(tg, o, d, step_size=0.6, near_clip=0.3, color_mode="sigmoid")


def test_kernel_arrays_and_chunk_bounds():
    jg, tg = random_grids(32, 9, seed=2)
    jb, tb = jbg.from_sparse_grid(jg), tbg.from_sparse_grid(tg)
    cells = ttm.build_kernel_arrays(tb)
    assert cells.dtype == torch.bfloat16 and tuple(cells.shape) == (tb.n_bricks, 512, 32)
    assert [ttm.channels(b) for b in (1, 4, 9, 16, 25)] == [8, 16, 32, 56, 80]
    np.testing.assert_array_equal(np_(cells[..., 0].float()), np_(tb.density_bricks))
    np.testing.assert_array_equal(np_(cells[..., 1:28].float()), np_(tb.sh_bricks))
    assert not np_(cells[..., 28:].float()).any()
    opts = tgrid.GridRenderOptions()
    assert ttm.default_chunks_for(tb, opts) == jtm.default_chunks_for(jb, jgrid.GridRenderOptions())
    assert ttm.active_chunk_bound(tb, 0.5) == jtm.active_chunk_bound(jb, 0.5)
    slim = ttm.geometry_only(tb)
    assert slim.n_bricks == tb.n_bricks and slim.density_bricks.numel() == tb.n_bricks
    _, rays = both(tile_rays(2, 8, 16, seed=3))
    need = ttm.required_chunks(tb, rays, opts, multiple=1)
    assert 1 <= need <= ttm.default_chunks_for(tb, opts)
    cut = ttm.render_tiles_pallas(tb, rays, opts, n_chunks=need)
    full = ttm.render_tiles_pallas(tb, rays, opts)
    np.testing.assert_array_equal(np_(cut["rgb"]), np_(full["rgb"]))
    bucketed = ttm.render_tiles_pallas_bucketed(tb, rays, opts, kernel_arrays=cells)
    assert "window_miss" not in bucketed
    np.testing.assert_array_equal(np_(bucketed["rgb"]), np_(full["rgb"]))


def test_the_kernel_wrapper_runs_on_a_card_only():
    """On host tensors ``march`` takes the plain version and launches
    nothing; the kernel's wrapper refuses them."""
    _, tg = random_grids(16, 1, seed=1)
    bg = tbg.from_sparse_grid(tg)
    _, rays = both(tile_rays(1, 4, 8, seed=2))
    pack, basis = ttm.pack_rays(bg, rays, tgrid.GridRenderOptions())
    cells = ttm.build_kernel_arrays(bg)
    before = ttm.tile_march_fwd.launches
    out = ttm.march(cells, bg.brick_links, bg.reso, pack, basis, max_steps=64)
    assert ttm.tile_march_fwd.launches == before
    assert tuple(out.shape) == (1, 8, 32)
    same, counts = ttm.march_reference(cells, bg.brick_links, bg.reso, pack, basis, max_steps=64, counts=True)
    torch.testing.assert_close(same, out, rtol=0, atol=0)
    assert tuple(counts["marched"].shape) == (1, 32) and tuple(counts["touched"].shape) == (bg.n_bricks,)
    with pytest.raises(ValueError, match="CUDA"):
        ttm.tile_march_fwd(cells, bg.brick_links, bg.reso, pack, basis, max_steps=64)
