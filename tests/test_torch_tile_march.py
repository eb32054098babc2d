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


def test_pack_rays_copies_no_host_numbers_after_its_first_call(monkeypatch):
    """The ray geometry of every march takes the grid's constants
    (resolution, radius, centre) from tensors kept on the device: on the
    card a copy of host numbers (torch.tensor, torch.as_tensor) waits for
    the queue to drain, once per call."""
    _, tg = random_grids(16, 9, seed=18)
    bg = tbg.from_sparse_grid(tg)
    _, rays = both(tile_rays(2, 8, 16, seed=19))
    opts = tgrid.GridRenderOptions()
    first = ttm.pack_rays(bg, rays, opts)
    copies = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            copies.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch, name, counted)
    again = ttm.pack_rays(bg, rays, opts)
    monkeypatch.undo()
    assert copies == []
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The kernel's empty-space skip, through its plain version
# ---------------------------------------------------------------------------

# 32^3 grid: the central 2x2x2 bricks and brick (3, 1, 1), on the upper x
# face, hold data; every face of each borders an empty brick
SKIP_BRICKS = [(x, y, z) for x in (1, 2) for y in (1, 2) for z in (1, 2)] + [(3, 1, 1)]


def skip_grids(seed=0, dens_hi=8.0):
    """(JAX grid, port grid) of 32^3, basis 9, with data only in
    SKIP_BRICKS (bf16-exact values)."""
    jg, _ = random_grids(32, 9, seed=seed, dens_hi=dens_hi, sphere=False)
    links = np.asarray(jg.links).copy()
    keep = np.zeros(links.shape, bool)
    for x, y, z in SKIP_BRICKS:
        keep[8 * x:8 * x + 8, 8 * y:8 * y + 8, 8 * z:8 * z + 8] = True
    links = np.where(keep, links, -1).astype(np.int32)
    jg = replace(jg, links=jnp.asarray(links))
    tg = SparseGrid.from_numpy(links, np.asarray(jg.density_data), np.asarray(jg.sh_data), jg.radius, jg.center, 9,
                               device="cpu")
    return jg, tg


def grid_point(g):
    """Grid coordinates -> world coordinates of a 32^3 grid of radius 1."""
    return (np.asarray(g, np.float32) + 0.5) / 16.0 - 1.0


def skip_rays():
    """Tiles of 8 rays [6, 8]: rays along y that graze the block's x faces
    (grid x 7.99, 8, 8.01, 15.99, 16, 23.99, 24, 24.01) at three depths,
    two tiles of them tilted by 1e-3; one tile entering through the upper
    x face (x = 31) into brick (3, 1, 1); two tiles of random directions
    through the block."""
    xs = [7.99, 8.0, 8.01, 15.99, 16.0, 23.99, 24.0, 24.01]
    os_, ds = [], []
    for z, tilt in ((12.5, 0.0), (8.0, 1e-3), (23.99, -1e-3)):
        os_.append([grid_point([x, -6.0, z]) for x in xs])
        ds.append([[tilt, 1.0, 0.5 * tilt]] * 8)
    os_.append([grid_point([40.0, 8.5 + i, 9.0 + 0.7 * i]) for i in range(8)])
    ds.append([[-1.0, 0.01 * i, -0.02 * i] for i in range(8)])
    rng = np.random.default_rng(7)
    for _ in range(2):
        o = rng.standard_normal(3)
        o = 2.5 * o / np.linalg.norm(o)
        os_.append([o] * 8)
        ds.append(list(grid_point([16.0, 16.0, 16.0]) + rng.uniform(-0.35, 0.35, (8, 3)) - o))
    o, d = (np.asarray(x, np.float32) for x in (os_, ds))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [o, d, d]


@pytest.fixture(scope="module")
def skip_case():
    """The skip grid's inputs of the plain march, and JAX's K3 (interpret
    mode) on two coherent tiles of it."""
    jg, tg = skip_grids()
    jb, tb = jbg.from_sparse_grid(jg), tbg.from_sparse_grid(tg)
    _, rays = both(skip_rays())
    opts = tgrid.GridRenderOptions(step_size=0.5)
    pack, basis = ttm.pack_rays(tb, rays, opts)
    jr, tr = both(tile_rays(2, 8, 16, seed=31))
    old = jtm.INTERPRET
    jtm.INTERPRET = True
    try:
        k3 = jtm.render_tiles_pallas(jb, jr, jgrid.GridRenderOptions(step_size=0.5), return_depth=True)
    finally:
        jtm.INTERPRET = old
    return dict(bg=tb, cells=ttm.build_kernel_arrays(tb), pack=pack, basis=basis,
                max_steps=ttm.default_chunks_for(tb, opts) * ttm.SC, k3=jax.tree_util.tree_map(np.asarray, k3),
                jrays=tr, opts=opts)


def skip_march(case, **kw):
    bg = case["bg"]
    return ttm.march_reference(case["cells"], bg.brick_links, bg.reso, case["pack"], case["basis"],
                               max_steps=case["max_steps"], **kw)


def test_reachable_bricks_is_the_occupancy_dilated_by_the_upper_neighbours():
    """Brick b is reachable iff one of b + {0, 1}^3 (clamped to the last
    brick holding a cell) is occupied: checked against loops on a random
    occupancy of an uneven 3 x 4 x 5-brick grid of 20 x 30 x 33 cells."""
    rng = np.random.default_rng(3)
    occ = rng.uniform(size=(3, 4, 5)) < 0.15
    links = np.where(occ, np.arange(occ.size).reshape(occ.shape), -1).astype(np.int32)
    reso = (20, 30, 33)
    got = np_(ttm.reachable_bricks(torch.from_numpy(links), reso))
    last = [(r - 1) >> 3 for r in reso]
    for b in np.ndindex(occ.shape):
        want = any(occ[tuple(min(b[a] + d[a], last[a]) for a in range(3))] for d in np.ndindex(2, 2, 2))
        assert got[b] == want, b
    assert got.sum() > occ.sum()


@pytest.mark.parametrize("early_stop", [False, True], ids=["full", "early_stop"])
def test_skipping_march_gives_the_same_bits_and_marches_fewer_samples(skip_case, early_stop):
    """The plain march visiting only the kernel's steps (the skip of every
    brick run it can prove reads nothing) equals the march that reads
    every sample, bit for bit, on rays that graze brick faces and enter
    through the upper face, and marches fewer samples; the counts of the
    bound see every sample that reaches data and a brick step per skip."""
    full, c_full = skip_march(skip_case, early_stop=early_stop, counts=True)
    skip, c_skip = skip_march(skip_case, early_stop=early_stop, counts=True, skip_empty=True)
    torch.testing.assert_close(skip, full, rtol=0, atol=0)
    marched, marched_skip = int(c_full["marched"].sum()), int(c_skip["marched"].sum())
    reach, steps = int(c_full["reach"].sum()), int(c_full["brick_steps"].sum())
    assert reach <= marched_skip < marched and steps > 0
    assert (np_(c_skip["marched"]) >= np_(c_full["reach"])).all()
    for k in ("shaded", "dense", "reach"):
        np.testing.assert_array_equal(np_(c_skip[k]), np_(c_full[k]), err_msg=k)
    acc = np_(full[:, 3])
    assert (acc[:3] > 0.05).mean() > 0.5 and acc[3].min() > 0.05  # the grazing and upper-face rays read data


def test_a_mask_without_the_upper_neighbours_skips_data(skip_case):
    """With the occupancy alone as the mask, the skip drops the samples
    whose upper corners cross into an occupied brick: the outputs change."""
    full = skip_march(skip_case)
    occ = skip_case["bg"].brick_links >= 0
    bad = skip_march(skip_case, skip_empty=True, reach=occ)
    assert float((bad - full).abs().max()) > 1e-2


def test_skipping_march_matches_jax_k3_on_rays_without_misses(skip_case):
    bg, opts = skip_case["bg"], skip_case["opts"]
    pack, basis = ttm.pack_rays(bg, skip_case["jrays"], opts)
    out = ttm.march_reference(skip_case["cells"], bg.brick_links, bg.reso, pack, basis,
                              max_steps=skip_case["max_steps"], skip_empty=True)
    got = ttm.march_outputs(out, pack, opts, return_depth=True)
    keep = skip_case["k3"]["miss_per_ray"] == 0
    assert keep.mean() >= 0.95, keep.mean()
    assert float(np_(got["acc"])[keep].max()) > 0.1
    assert_close_on(got, skip_case["k3"], keep, K3_TOL, "skipping plain K3 vs JAX K3")


# ---------------------------------------------------------------------------
# The backward's skip and its pre-summed adds, through their host twins
# ---------------------------------------------------------------------------

TWIN_TOL = 1e-5  # of scale: the runs' float32 sums against the plain version's, in another order


def backward_seeds(bg, pack, basis, max_steps, opts, seed):
    """The backward's g and S_total (beta on) from the plain march against
    a random target."""
    cells = ttm.build_kernel_arrays(bg)
    out = ttm.march_reference(cells, bg.brick_links, bg.reso, pack, basis, max_steps=max_steps)
    gt = torch.from_numpy(np.random.default_rng(seed).uniform(0.0, 1.0, tuple(pack.shape[:2]) + (3,)).astype(np.float32))
    _, g, s_total = ttm.loss_seeds(out, gt, opts, beta_loss=1e-3)
    return cells, g, s_total


def skip_backward(case, sparsity, **kw):
    bg = case["bg"]
    _, g, s_total = backward_seeds(bg, case["pack"], case["basis"], case["max_steps"], case["opts"], seed=5)
    return ttm.march_backward_reference(case["cells"], bg.brick_links, bg.reso, case["pack"], case["basis"], g,
                                        s_total, max_steps=case["max_steps"], sparsity_scale=sparsity, **kw)


@pytest.mark.parametrize("sparsity", [0.0, 1e-3], ids=["mse", "sparsity"])
def test_skipping_backward_gives_the_same_bits(skip_case, sparsity):
    """The plain backward visiting only the kernel's steps equals the one
    that reads every sample, bit for bit, with the sparsity loss off and
    on (a skipped sample has sigma 0: no g_sigma, no sparsity term, cum
    and P unchanged), on rays that graze brick faces and enter through the
    upper face."""
    full = skip_backward(skip_case, sparsity)
    skip = skip_backward(skip_case, sparsity, skip_empty=True)
    assert float(full[0].abs().max()) > 0 and float(full[1].abs().max()) > 0
    for got, want in zip(skip, full):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_backward_mask_without_the_upper_neighbours_loses_gradient(skip_case):
    """With the occupancy alone as the mask, the skip drops the samples
    whose upper corners cross into an occupied brick: their corners lose
    gradient."""
    full = skip_backward(skip_case, 0.0)
    occ = skip_case["bg"].brick_links >= 0
    bad = skip_backward(skip_case, 0.0, skip_empty=True, reach=occ)
    for got, want in zip(bad, full):
        assert float((got - want).abs().max() / want.abs().max()) > 1e-2


def flush_case(coherent):
    bg = coherent["bg"]
    opts = tgrid.GridRenderOptions(step_size=0.5)
    _, pack, basis, max_steps = ttm.march_inputs(bg, coherent["rays"], opts)
    cells, g, s_total = backward_seeds(bg, pack, basis, max_steps, opts, seed=6)
    return bg, cells, pack, basis, g, s_total, max_steps


@pytest.mark.parametrize("sparsity", [0.0, 1e-3], ids=["mse", "sparsity"])
def test_flush_twin_sums_to_the_plain_backward_with_fewer_adds(coherent, sparsity):
    """The kernel's runs (a slot's sums while its cell stays a corner),
    summed run by run with the tile basis, give the plain backward's
    gradients to float32 rounding, and add fewer floats than the first
    port's 8 (1 + 3B) a shaded sample on coherent tiles, in fewer than
    half as many add instructions."""
    bg, cells, pack, basis, g, s_total, max_steps = flush_case(coherent)
    kw = dict(max_steps=max_steps, sparsity_scale=sparsity)
    want = ttm.march_backward_reference(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
    f = ttm.backward_flushes(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, **kw)
    B, r = basis.shape[-1], pack.shape[1]
    grad_d = torch.zeros(bg.n_bricks * 512).index_add_(0, f["cell"], f["density"])
    tile_basis = basis[f["ray"] // r]
    grad_sh = torch.zeros(bg.n_bricks * 512, 3 * B).index_add_(
        0, f["cell"], (f["colour"][:, :, None] * tile_basis[:, None, :]).reshape(-1, 3 * B))
    for got, w in ((grad_d, want[0]), (grad_sh, want[1])):
        w = w.reshape(got.shape)
        assert float((got - w).abs().max()) <= TWIN_TOL * float(w.abs().max())
    _, counts = ttm.march_reference(cells, bg.brick_links, bg.reso, pack, basis, max_steps=max_steps,
                                    early_stop=True, counts=True)
    assert 0 < f["adds"] < 8 * (1 + 3 * B) * int(counts["shaded"].sum())
    assert f["add_ops"] < f["adds"] / 2  # the rows go out mostly as float4s
