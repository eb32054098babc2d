"""The port's Plenoxels training step on the CPU, through the plain
versions of its kernels, against the JAX package: the backward of the
tile march (K4, JAX's Pallas kernel in interpret mode), the fused render
+ gradient, the sampled TV over bricks, the optimizer and whole
``train_step_tiles_pallas`` steps from the same state.

The TPU march reads 2x2x2-brick windows and drops the samples outside
them; on a 16^3 grid (2^3 bricks) one window holds the whole grid, so
JAX's march misses nothing there (asserted), and both packages march the
same samples. Grid values are rounded to bf16 first, so the port's bf16
cells hold them exactly."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_projects_tpu.ops.pallas.tile_march as jtm
from nerf_projects_tpu.ops import brick_grid as jbg
from nerf_projects_tpu.ops import grid as jgrid
from nerf_projects_tpu.ops import tv as jtvc
from nerf_projects_tpu.ops import tv_bricks as jtv
from nerf_projects_tpu.train import plenoxels_trainer as jpt
from nerf_projects_tpu_torch.data.synthetic import make_dataset, tile_batches
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.ops import brick_grid as tbg
from nerf_projects_tpu_torch.ops import grid as tgrid
from nerf_projects_tpu_torch.ops import tv as ttvc
from nerf_projects_tpu_torch.ops import tv_bricks as ttv
from nerf_projects_tpu_torch.ops.kernels import tile_march as ttm
from nerf_projects_tpu_torch.ops.tile_render import render_tiles
from nerf_projects_tpu_torch.train import plenoxels_trainer as tpt
from tests.test_torch_tile_march import both, f32_twin, np_, random_grids, tile_rays

BF16_TOL = 3e-2    # of scale: the JAX package's K4-vs-twin bound (test_tile_march_pallas.py:262-272)
TWIN_TOL = 1e-4    # of scale: float32 on both sides, sums in another order
AUTOGRAD_TOL = 1e-5  # of scale: the same float32 march, autograd against the hand-written backward
K3_TWIN_TOL = 2e-2   # of scale: bf16 cells against float32 (the JAX package's K3-vs-twin bound)
TV_TOL = 1e-6
LUMISPHERE_TOL = 1e-5  # of scale (test_cell_tv_gradients_match_jax)
OPTIM_RTOL = 1e-6  # ulp-level: the update's expression in the same order
LOSSES = {"mse": (0.0, 0.0), "beta+sparsity": (1e-3, 1e-4)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module runs torch on one thread. With several, the CPU
    backward of an indexed gather (the autograd references below) adds
    its contributions in an order that changes from run to run, and a
    run among other test processes once strayed 5.9e-5 of scale from the
    hand-written backward (1e-6 alone); the module also ran 6.6x slower
    there, each small op waiting on oversubscribed threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_close_of_scale(got, want, tol, what):
    got, want = np_(got).astype(np.float64), np_(want).astype(np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err < tol, f"{what}: max |err| {err:.3e} of scale, tolerance {tol}"


def port_grid(reso, basis_dim, seed, dens_hi=6.0, sphere=True):
    _, tg = random_grids(reso, basis_dim, seed=seed, dens_hi=dens_hi, sphere=sphere)
    return tbg.from_sparse_grid(tg)


def gt_for(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(np.float32)


def autograd_grads(bg, rays, gt, opts, cells, beta, spars):
    """d(mse + beta + sparsity) / d(cells) through torch autograd of the
    plain march on float32 cells: (grad_density, grad_sh)."""
    c = cells.detach().clone().requires_grad_(True)
    _, pack, basis, max_steps = ttm.march_inputs(bg, rays, opts, kernel_arrays=c)
    out = ttm.march_reference(c, bg.brick_links, bg.reso, pack, basis, max_steps=max_steps,
                              color_mode=opts.color_mode)
    res = ttm.march_outputs(out, pack, opts, False)
    loss = torch.mean((res["rgb"] - gt) ** 2)
    if beta:
        lt = res["log_transmit"]
        loss = loss + beta * torch.mean(lt + torch.log(1.0 - torch.exp(lt) + 1e-3))
    if spars:
        loss = loss + spars * torch.sum(res["sparsity_sum"])
    (g,) = torch.autograd.grad(loss, c)
    B = bg.basis_dim
    return g[..., 0], g[..., 1:1 + 3 * B]


# (color mode, losses, tile th x tw, basis_dim, density upper bound): the
# 60-density grids stop rays (T under stop_thresh) long before their exit
K4_CASES = [(m, l, t, 9, d) for m in ("bias", "sigmoid") for l in LOSSES
            for t, d in (((8, 16), 6.0), ((16, 16), 60.0), ((1, 37), 60.0))]
K4_CASES += [("bias", "beta+sparsity", (8, 16), 1, 60.0), ("sigmoid", "beta+sparsity", (16, 16), 16, 6.0)]


@pytest.mark.parametrize("mode,losses,tile,basis_dim,dens_hi", K4_CASES,
                         ids=[f"{m}-{l}-r{t[0] * t[1]}-B{b}-d{int(d)}" for m, l, t, b, d in K4_CASES])
def test_plain_backward_matches_autograd_of_the_plain_march(mode, losses, tile, basis_dim, dens_hi):
    bg = port_grid(32 if basis_dim == 9 else 16, basis_dim, seed=tile[1] + basis_dim, dens_hi=dens_hi)
    _, rays = both(tile_rays(2, *tile, seed=tile[0]))
    opts = tgrid.GridRenderOptions(step_size=0.5, color_mode=mode)
    gt = torch.from_numpy(gt_for((2, tile[0] * tile[1], 3), seed=basis_dim))
    beta, spars = LOSSES[losses]
    cells = ttm.build_kernel_arrays(bg, torch.float32)
    rgb, gd, gsh, aux = ttm.render_fused_tiles_pallas(bg, rays, gt, opts, beta_loss=beta, sparsity_loss=spars,
                                                      kernel_arrays=cells)
    if dens_hi > 10:  # rays go inactive: the stop and the sparsity past it are exercised
        assert float(aux["log_transmit"].min()) < np.log(opts.stop_thresh)
    wd, ws = autograd_grads(bg, rays, gt, opts, cells, beta, spars)
    assert gd.shape == wd.shape and gsh.shape == ws.shape
    assert float(wd.abs().max()) > 0 and float(ws.abs().max()) > 0
    assert_close_of_scale(gd, wd, AUTOGRAD_TOL, "grad_density")
    assert_close_of_scale(gsh, ws, AUTOGRAD_TOL, "grad_sh")


def jax_fused_case(th, tw):
    """Two coherent tiles of th x tw rays on a 16^3 grid with the beta and
    sparsity losses on, through JAX's fused render + gradient (K3 + K4 in
    interpret mode) and its float32 twin under jax.grad."""
    jg, tg = random_grids(16, 9, seed=th + 40)
    jb, tb = jbg.from_sparse_grid(jg), tbg.from_sparse_grid(tg)
    jr, tr = both(tile_rays(2, th, tw, seed=tw + 7))
    gt = gt_for((2, th * tw, 3), seed=th)
    beta, spars = LOSSES["beta+sparsity"]
    opts_j = jgrid.GridRenderOptions()
    old = jtm.INTERPRET
    jtm.INTERPRET = True
    try:
        k4 = jtm.render_fused_tiles_pallas(jb, jr, jnp.asarray(gt), opts_j, beta_loss=beta, sparsity_loss=spars)
    finally:
        jtm.INTERPRET = old

    def twin_loss(dens, sh):
        out = f32_twin(replace(jb, density_bricks=dens, sh_bricks=sh), jr, opts_j, steps_per_chunk=jtm.SC)
        lt = out["log_transmit"]
        return (jnp.mean((out["rgb"] - gt) ** 2) + beta * jnp.mean(lt + jnp.log(1.0 - jnp.exp(lt) + 1e-3))
                + spars * jnp.sum(out["sparsity_sum"]))

    twin = jax.grad(twin_loss, argnums=(0, 1))(jb.density_bricks, jb.sh_bricks)
    return dict(k4=jax.tree_util.tree_map(np.asarray, k4), twin=tuple(np.asarray(x) for x in twin),
                twin_window_miss=float(f32_twin(jb, jr, opts_j, steps_per_chunk=jtm.SC)["window_miss"]),
                jb=jb, tb=tb, jr=jr, tr=tr, gt=gt, beta=beta, spars=spars)


@pytest.fixture(scope="module")
def fused():
    """JAX's interpret-mode calls, made once per tile size for the module."""
    cache = {}

    def get(tile):
        if tile not in cache:
            cache[tile] = jax_fused_case(*tile)
        return cache[tile]

    return get


TILES = pytest.mark.parametrize("tile", [(8, 16), (16, 16)], ids=["r128", "r256"])


@TILES
def test_fused_route_matches_jax_fused_route(fused, tile):
    """The port's fused route against JAX's, and the port's backward fed
    the loss gradient and suffix seed that JAX's K4 receives. JAX forms
    them with N = T * 128 (``fused_grad_blocks``' module constant R)
    whatever the tile size, so on 256-ray tiles its MSE and beta
    gradients are twice the loss's; the port divides by the rays it
    renders (held against autograd and the float32 twin below). On
    128-ray tiles the two routes are the same function."""
    f = fused(tile)
    rgb_j, gd_j, gsh_j, aux_j = f["k4"]
    assert float(aux_j["window_miss"]) == 0.0
    tb, tr, gt = f["tb"], f["tr"], torch.from_numpy(f["gt"])
    opts = tgrid.GridRenderOptions()
    rgb, gd, gsh, aux = ttm.render_fused_tiles_pallas(tb, tr, gt, opts, beta_loss=f["beta"],
                                                      sparsity_loss=f["spars"])
    assert gd.dtype == torch.float32 and gsh.shape == gsh_j.shape
    assert_close_of_scale(rgb, rgb_j, BF16_TOL, "rgb_out")
    for k in ("acc", "log_transmit", "sparsity_sum"):
        assert_close_of_scale(aux[k], aux_j[k], BF16_TOL, k)
    assert float(aux["window_miss"]) == 0.0 and int(aux["dropped_active_chunks"]) == 0

    cells, pack, basis, max_steps = ttm.march_inputs(tb, tr, opts)
    n_jax = pack.shape[0] * 128
    g = 2.0 * (rgb - gt) / (3.0 * n_jax)
    t_fin = torch.exp(aux["log_transmit"])
    s_total = torch.sum(g * rgb, dim=-1) + (f["beta"] / n_jax) * (1.0 - t_fin / (1.0 - t_fin + 1e-3))
    gd_k4, gsh_k4 = ttm.march_backward(cells, tb.brick_links, tb.reso, pack, basis, g.contiguous(),
                                       s_total.contiguous(), max_steps=max_steps, sparsity_scale=f["spars"])
    assert_close_of_scale(gd_k4, gd_j, BF16_TOL, "K4 grad_density")
    assert_close_of_scale(gsh_k4, gsh_j, BF16_TOL, "K4 grad_sh")
    if tile == (8, 16):
        torch.testing.assert_close(gd, gd_k4, rtol=0, atol=0)
        torch.testing.assert_close(gsh, gsh_k4, rtol=0, atol=0)


@TILES
def test_float32_fused_route_matches_jax_grad_of_the_float32_twin(fused, tile):
    f = fused(tile)
    assert f["twin_window_miss"] == 0.0
    tb = f["tb"]
    _, gd, gsh, _ = ttm.render_fused_tiles_pallas(
        tb, f["tr"], torch.from_numpy(f["gt"]), tgrid.GridRenderOptions(), beta_loss=f["beta"],
        sparsity_loss=f["spars"], kernel_arrays=ttm.build_kernel_arrays(tb, torch.float32))
    assert_close_of_scale(gd, f["twin"][0], TWIN_TOL, "grad_density")
    assert_close_of_scale(gsh, f["twin"][1], TWIN_TOL, "grad_sh")


@pytest.mark.parametrize("ignore_edge", [False, True], ids=["density", "sh"])
def test_tv_grad_bricks_matches_jax(ignore_edge):
    jg, tg = random_grids(32, 9, seed=11)
    jb, tb = jbg.from_sparse_grid(jg), tbg.from_sparse_grid(tg)
    rows = ((jb.n_bricks - 4 + np.arange(9)) % jb.n_bricks).astype(np.int32)  # a window that wraps around
    jdata, tdata = (jb.sh_bricks, tb.sh_bricks) if ignore_edge else (jb.density_bricks, tb.density_bricks)
    want = jtv.tv_grad_bricks(jb, jdata, jnp.asarray(rows), scale=1e-3, ignore_edge=ignore_edge)
    got = ttv.tv_grad_bricks(tb, tdata, torch.from_numpy(rows), scale=1e-3, ignore_edge=ignore_edge)
    assert got.shape == tdata.shape and float(got.abs().max()) > 0
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=TV_TOL, atol=TV_TOL * float(np.abs(want).max()))
    gen = torch.Generator().manual_seed(0)
    window = ttv.sample_brick_window(gen, tb.n_bricks, 5)
    assert window.dtype == torch.int32 and ((window[1:] - window[:-1]) % tb.n_bricks == 1).all()


OPTIM_CASES = {
    "rmsprop-bootstrap": ("rmsprop", "zero", None),
    "rmsprop-steady": ("rmsprop", "random", None),
    "rmsprop-floor": ("rmsprop", "random", 0.0),
    "sgd-floor": ("sgd", "zero", -0.5),
}


@pytest.mark.parametrize("case", list(OPTIM_CASES))
def test_optim_matches_jax(case):
    optim, rms_kind, minval = OPTIM_CASES[case]
    rng = np.random.default_rng(4)
    data = rng.standard_normal((64, 27)).astype(np.float32)
    grad = (rng.standard_normal((64, 27)) * 1e-2).astype(np.float32)
    grad[::7] = 0.0
    rms = np.zeros_like(data) if rms_kind == "zero" else (rng.uniform(0, 1e-4, data.shape)).astype(np.float32)
    rms[::5] = 0.0
    lr = np.float32(0.37)
    jt = jpt.PlenoxelsTrainer(rms_beta=0.95)
    tt = tpt.PlenoxelsTrainer(rms_beta=0.95, device="cpu")
    want = jt._optim(optim, jnp.asarray(data), jnp.asarray(grad), jnp.asarray(rms), jnp.float32(lr), minval=minval)
    got = tt._optim(optim, *(torch.from_numpy(x) for x in (data, grad, rms)), float(lr), minval=minval)
    for g, w, name in zip(got, want, ("data", "rms")):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=OPTIM_RTOL, atol=1e-12, err_msg=name)
    if minval is not None:
        assert float(got[0].min()) >= minval


def jax_step_state(jb):
    """Optimizer state with zero rms on even bricks (the bootstrap) and
    a running mean elsewhere."""
    rng = np.random.default_rng(8)
    rd = rng.uniform(0, 1e-6, jb.density_bricks.shape).astype(np.float32)
    rs = rng.uniform(0, 1e-6, jb.sh_bricks.shape).astype(np.float32)
    rd[::2], rs[::2] = 0.0, 0.0
    return rd, rs


def test_train_step_tiles_pallas_matches_jax_from_the_same_state(fused, monkeypatch):
    """One step of each package from one state, on 128-ray tiles: the
    JAX grid and rms carried across with brick_grid_from_numpy /
    RMSState.from_numpy, the TV windows JAX draws fed to the port. JAX's
    step reuses the fixture's fused render + gradient (same arguments),
    so its interpret-mode kernels run once."""
    fused = fused((8, 16))
    jb, jr, gt = fused["jb"], fused["jr"], fused["gt"]
    kw = dict(n_iters=1000, lambda_tv=1e-3, tv_sparsity=0.5, lambda_tv_sh=1e-2, tv_sh_sparsity=0.5,
              lambda_beta=fused["beta"], lambda_sparsity=fused["spars"], lambda_l2_sh=1e-4,
              lr_sigma_delay_steps=0, density_minval=0.0)
    jtrain = jpt.PlenoxelsTrainer(jgrid.GridRenderOptions(), **kw)
    ttrain = tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(), device="cpu", **kw)
    rd, rs = jax_step_state(jb)
    step, key = 7, jax.random.PRNGKey(5)

    cached = fused["k4"]

    def cached_fused(bg, rays, rgb_gt, opts, *, beta_loss, sparsity_loss, **_):
        assert (beta_loss, sparsity_loss) == (fused["beta"], fused["spars"])
        return tuple(jax.tree_util.tree_map(jnp.asarray, cached))

    monkeypatch.setattr(jtm, "render_fused_tiles_pallas", cached_fused)
    new_jb, new_jrms, jstats = jtrain.train_step_tiles_pallas(
        jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jb),  # the step donates its state
        jpt.RMSState(jnp.asarray(rd), jnp.asarray(rs)), jr, jnp.asarray(gt), jnp.float32(step), key)
    monkeypatch.undo()

    # the JAX step's gradients, composed from its pieces as the step does
    nb = jb.n_bricks
    k_tv, k_sh = jax.random.split(key)
    rows = [np.array(jtv.sample_brick_window(k, nb, max(int(0.5 * nb), 1))) for k in (k_tv, k_sh)]
    _, gd_j, gsh_j, _ = cached
    gd_j = (gd_j + np.asarray(jtv.tv_grad_bricks(jb, jb.density_bricks, jnp.asarray(rows[0]), scale=1e-3,
                                                 ignore_edge=False))) * np.asarray(jb.cell_mask)
    gsh_j = (gsh_j + np.asarray(jtv.tv_grad_bricks(jb, jb.sh_bricks, jnp.asarray(rows[1]), scale=1e-2,
                                                   ignore_edge=True))
             + (1e-4 / (nb * 512)) * np.asarray(jb.sh_bricks)) * np.asarray(jb.cell_mask)[..., None]

    tb = tbg.brick_grid_from_numpy(*(np.asarray(x) for x in (jb.brick_links, jb.density_bricks, jb.sh_bricks,
                                                             jb.cell_mask, jb.brick_coords)),
                                   jb.reso, jb.radius, jb.center, jb.basis_dim, device="cpu")
    trms = tpt.RMSState.from_numpy(rd, rs, device="cpu")
    drawn = iter(torch.from_numpy(r) for r in rows)
    monkeypatch.setattr(tpt, "sample_brick_window", lambda gen, n, w: next(drawn))
    gen = torch.Generator().manual_seed(0)
    gd, gsh, _ = ttrain.tiles_pallas_grads(tb, fused["tr"], torch.from_numpy(gt), gen)
    assert_close_of_scale(gd, gd_j, BF16_TOL, "step grad_density")
    assert_close_of_scale(gsh, gsh_j, BF16_TOL, "step grad_sh")

    drawn = iter(torch.from_numpy(r) for r in rows)
    new_tb, new_trms, tstats = ttrain.train_step_tiles_pallas(tb, trms, fused["tr"], torch.from_numpy(gt), step, gen)
    assert_close_of_scale(tstats["mse"], jstats["mse"], BF16_TOL, "mse")
    # RMSprop's bootstrap moves a cell by lr sign(g): compare where the
    # gradient is clear of noise
    for got, want, g, name in ((new_tb.density_bricks, new_jb.density_bricks, gd_j, "density"),
                               (new_tb.sh_bricks, new_jb.sh_bricks, gsh_j, "sh"),
                               (new_trms.rms_density, new_jrms.rms_density, gd_j, "rms_density"),
                               (new_trms.rms_sh, new_jrms.rms_sh, gsh_j, "rms_sh")):
        keep = np.abs(g) > 1e-3 * np.abs(g).max()
        assert keep.sum() > 100
        got, want = np_(got)[keep], np.asarray(want)[keep]
        if name.startswith("rms"):
            np.testing.assert_allclose(got, want, rtol=2 * BF16_TOL, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL * np.abs(want).max(), err_msg=name)
    dead = ~np_(new_tb.cell_mask)
    assert not np_(new_tb.density_bricks)[dead].any()


@pytest.mark.parametrize("cells", ["float32", "bfloat16"])
def test_fused_route_matches_autograd_of_the_plain_step(cells):
    """render_fused_tiles_pallas against torch autograd of
    train_step_tiles' loss (through render_tiles), both plain on the CPU:
    float32 cells march the same samples (1e-5 of scale); the default
    bf16 cells are held at the JAX package's K3-vs-twin bound."""
    bg = port_grid(32, 9, seed=12)
    _, rays = both(tile_rays(3, 8, 16, seed=13))
    gt = torch.from_numpy(gt_for((3, 128, 3), seed=14))
    opts = tgrid.GridRenderOptions(step_size=0.5)
    dens = bg.density_bricks.clone().requires_grad_(True)
    sh = bg.sh_bricks.clone().requires_grad_(True)
    res = render_tiles(replace(bg, density_bricks=dens, sh_bricks=sh), rays, opts, steps_per_chunk=ttm.SC)
    lt = res["log_transmit"]
    loss = (torch.mean((res["rgb"] - gt) ** 2) + 1e-3 * torch.mean(lt + torch.log(1.0 - torch.exp(lt) + 1e-3))
            + 1e-4 * torch.sum(res["sparsity_sum"]))
    wd, ws = torch.autograd.grad(loss, (dens, sh))
    _, gd, gsh, _ = ttm.render_fused_tiles_pallas(bg, rays, gt, opts, beta_loss=1e-3, sparsity_loss=1e-4,
                                                  kernel_arrays=ttm.build_kernel_arrays(bg, getattr(torch, cells)))
    tol = AUTOGRAD_TOL if cells == "float32" else K3_TWIN_TOL
    assert_close_of_scale(gd, wd, tol, "grad_density")
    assert_close_of_scale(gsh, ws, tol, "grad_sh")


def test_train_step_tiles_pallas_reduces_loss():
    """The port of TestPallasTrainer.test_pallas_train_step_reduces_loss:
    30 steps on the synthetic scene, the MSE falls by 30%."""
    ds = make_dataset(n_views=4, image_size=64, device="cpu")
    g = SparseGrid.create(16, basis_dim=9, radius=1.3, use_sphere_bound=True, init_density=0.1, device="cpu")
    bg = tbg.from_sparse_grid(g)
    tr = tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(), n_iters=100, lr_sigma=3e0, lr_sigma_delay_steps=0,
                              lr_sh=1e-1, lambda_tv=1e-6, lambda_tv_sh=1e-7, lambda_sparsity=1e-6, device="cpu")
    rms = tr.init_rms_bricks(bg)
    gen = torch.Generator().manual_seed(0)
    batches = tile_batches(gen, ds, 2, 8, 16)
    mses = []
    for i in range(30):
        rays, target = next(batches)
        bg, rms, st = tr.train_step_tiles_pallas(bg, rms, rays, target, i, gen)
        mses.append(float(st["mse"]))
    assert np.isfinite(mses).all()
    assert np.mean(mses[-5:]) < np.mean(mses[:5]) * 0.7, mses


def test_train_step_tiles_matches_the_fused_step():
    """train_step_tiles (autograd through render_tiles) and the fused step
    take the same step from one state on float32-exact data: the same
    MSE, and masters that agree where the gradient is clear of noise."""
    bg = port_grid(16, 9, seed=15)
    _, rays = both(tile_rays(2, 8, 16, seed=16))
    gt = torch.from_numpy(gt_for((2, 128, 3), seed=17))
    tr = tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(), lambda_tv=1e-4, tv_sparsity=0.5, device="cpu")
    rms = tr.init_rms_bricks(bg)
    a_bg, a_rms, a = tr.train_step_tiles(bg, rms, rays, gt, 3, torch.Generator().manual_seed(1))
    b_bg, b_rms, b = tr.train_step_tiles_pallas(bg, rms, rays, gt, 3, torch.Generator().manual_seed(1))
    assert_close_of_scale(a["mse"], b["mse"], K3_TWIN_TOL, "mse")
    for x, y in ((a_rms.rms_density, b_rms.rms_density), (a_rms.rms_sh, b_rms.rms_sh)):
        assert_close_of_scale(x, y, 2 * K3_TWIN_TOL, "rms")


def test_backward_wrapper_and_entry_points_refuse_the_host_without_asking():
    bg = port_grid(16, 1, seed=1)
    _, rays = both(tile_rays(1, 4, 8, seed=2))
    cells, pack, basis, max_steps = ttm.march_inputs(bg, rays, tgrid.GridRenderOptions())
    g = torch.zeros(1, 32, 3)
    s = torch.zeros(1, 32)
    before = ttm.tile_march_bwd.launches
    gd, gsh = ttm.march_backward(cells, bg.brick_links, bg.reso, pack, basis, g, s, max_steps=max_steps)
    assert ttm.tile_march_bwd.launches == before
    assert tuple(gd.shape) == (bg.n_bricks, 512) and tuple(gsh.shape) == (bg.n_bricks, 512, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ttm.tile_march_bwd(cells, bg.brick_links, bg.reso, pack, basis, g, s, max_steps=max_steps)
    with pytest.raises(ValueError, match="CUDA"):
        ttm.tile_march_bwd_probe(cells, bg.brick_links, bg.reso, pack, basis, g, s, max_steps=max_steps,
                                 color_mode="bias", sigma_thresh=1e-8, stop_thresh=1e-7, sparsity_scale=0.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpt.PlenoxelsTrainer()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpt.RMSState.from_numpy(np.zeros((1, 512)), np.zeros((1, 512, 3)))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbg.brick_grid_from_numpy(*(np_(x) for x in (bg.brick_links, bg.density_bricks, bg.sh_bricks,
                                                         bg.cell_mask, bg.brick_coords)),
                                      bg.reso, bg.radius, bg.center, 1)
    tr = tpt.PlenoxelsTrainer(device="cpu")
    assert tr.device.type == "cpu"


def test_a_training_step_copies_no_host_numbers_to_its_device(monkeypatch):
    """After a first step, a step builds no tensor from host numbers: on
    the card each such copy (torch.tensor, torch.as_tensor) waits for the
    queue to drain. The grid's constants (resolution, radius, centre,
    corner offsets) are copied once and reused."""
    bg = port_grid(16, 9, seed=18)
    _, rays = both(tile_rays(2, 8, 16, seed=19))
    gt = torch.from_numpy(gt_for((2, 128, 3), seed=20))
    tr = tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(), lambda_tv=1e-4, tv_sparsity=0.5, lambda_l2_sh=1e-4,
                              device="cpu")
    gen = torch.Generator().manual_seed(2)
    opts = tgrid.GridRenderOptions()
    ttm.pack_rays(bg, rays, opts)
    bg, rms, _ = tr.train_step_tiles_pallas(bg, tr.init_rms_bricks(bg), rays, gt, 0, gen)
    copies = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            copies.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch, name, counted)
    ttm.pack_rays(bg, rays, opts)
    assert copies == []  # the ray geometry of the serving path too
    bg, rms, stats = tr.train_step_tiles_pallas(bg, rms, rays, gt, 1, gen)
    monkeypatch.undo()
    assert copies == [] and bool(torch.isfinite(stats["mse"]))


# ---------------------------------------------------------------------------
# The cell route: ops/tv.py and train_step over a SparseGrid
# ---------------------------------------------------------------------------

def lumisphere_draws(key):
    """The view direction and perturbation axis that JAX's
    tv_lumisphere_grad_sampled draws from ``key``."""
    k_dir, k_perturb = jax.random.split(key)
    return tuple(np.array(jax.random.normal(k, (3,))) for k in (k_dir, k_perturb))


TV_CELL_CASES = ["density", "sh", "lumisphere", "lumisphere-dir", "l2"]


@pytest.mark.parametrize("case", TV_CELL_CASES)
def test_cell_tv_gradients_match_jax(case):
    jg, tg = random_grids(16, 4, seed=21)
    links_j, links_t = jg.links, tg.links
    gs = 16 ** 3
    cells = ((gs - 700 + np.arange(1500)) % gs).astype(np.int32)  # a window that wraps around
    cj, ct = jnp.asarray(cells), torch.from_numpy(cells)
    if case in ("density", "sh"):
        jd, td = (jg.density_data, tg.density_data) if case == "density" else (jg.sh_data, tg.sh_data)
        want = jtvc.tv_grad_sampled(links_j, jd, cj, scale=1e-2, ignore_edge=case == "sh")
        got = ttvc.tv_grad_sampled(links_t, td, ct, scale=1e-2, ignore_edge=case == "sh")
    elif case.startswith("lumisphere"):
        key = jax.random.PRNGKey(4)
        df = 0.5 if case.endswith("dir") else 0.0
        want = jtvc.tv_lumisphere_grad_sampled(links_j, jg.sh_data, cj, key, basis_dim=4, scale=1e-2, dir_factor=df)
        got = ttvc.tv_lumisphere_grad_sampled(links_t, tg.sh_data, ct,
                                              tuple(torch.from_numpy(d) for d in lumisphere_draws(key)),
                                              basis_dim=4, scale=1e-2, dir_factor=df)
    else:
        want = jtvc.l2_color_grad(jg.sh_data, scale=1e-2)
        got = ttvc.l2_color_grad(tg.sh_data, scale=1e-2)
    want = np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 0
    # the lumisphere decodes the colour (a float32 sum over B in another
    # order) and its base cell subtracts two bases: ~1e-6 of scale apart
    tol = LUMISPHERE_TOL if case.startswith("lumisphere") else TV_TOL
    np.testing.assert_allclose(np_(got), want, rtol=tol, atol=tol * np.abs(want).max())
    window = ttvc.sample_window(torch.Generator().manual_seed(1), gs, 9)
    assert window.dtype == torch.int32 and ((window[1:] - window[:-1]) % gs == 1).all()


CELL_TOL = 1e-5  # of scale: the per-ray render under autograd, float32 sums in another order


def test_cell_train_step_matches_jax_from_the_same_state(monkeypatch):
    """One train_step (the reference-exact cell route) of each package
    from one SparseGrid state, every TV term on, the windows and the
    lumisphere's directions that JAX draws fed to the port: the
    gradients within CELL_TOL of scale, the updated masters and rms where
    the gradient is clear of noise."""
    jg, tg = random_grids(16, 4, seed=22)
    o, d, v = (x.reshape(-1, 3) for x in tile_rays(1, 8, 8, seed=23))
    jr, tr = both([o, d, v])
    gt = gt_for((64, 3), seed=24)
    kw = dict(n_iters=1000, lambda_tv=1e-3, tv_sparsity=0.05, lambda_tv_sh=1e-2, tv_sh_sparsity=0.05,
              lambda_tv_lumisphere=1e-3, tv_lumisphere_sparsity=0.05, tv_lumisphere_dir_factor=0.5,
              lambda_l2_sh=1e-4, lambda_beta=1e-3, lambda_sparsity=1e-4, lr_sigma_delay_steps=0)
    jtrain = jpt.PlenoxelsTrainer(jgrid.GridRenderOptions(), **kw)
    ttrain = tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(), device="cpu", **kw)
    rng = np.random.default_rng(25)
    rd = rng.uniform(0, 1e-6, tg.density_data.shape).astype(np.float32)
    rs = rng.uniform(0, 1e-6, tg.sh_data.shape).astype(np.float32)
    rd[::2], rs[::2] = 0.0, 0.0
    step, key = 5, jax.random.PRNGKey(6)

    # JAX's gradients, composed from its pieces as its train_step does
    def loss_fn(dens, sh):
        out = jgrid.volume_render_grid(replace(jg, density_data=dens, sh_data=sh), jr, jtrain.opts)
        return jtrain._data_loss(out, jnp.asarray(gt))

    (_, mse_j), (gd_j, gsh_j) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(jg.density_data,
                                                                                         jg.sh_data)
    tv_d, tv_s = jtrain._tv_grads(jg, key)
    gd_j, gsh_j = np.asarray(gd_j + tv_d), np.asarray(gsh_j + tv_s)
    new_jg, new_jrms, jstats = jtrain.train_step(
        jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jg),  # the step donates its state
        jpt.RMSState(jnp.asarray(rd), jnp.asarray(rs)), jr, jnp.asarray(gt), jnp.float32(step), key)

    gs = 16 ** 3
    k_tv, k_sh, k_lum = jax.random.split(key, 3)
    windows = [np.array(jtvc.sample_window(k, gs, max(int(0.05 * gs), 1))) for k in (k_tv, k_sh, k_lum)]
    dirs = tuple(torch.from_numpy(x) for x in lumisphere_draws(k_lum))

    def feed():
        drawn = iter(torch.from_numpy(w) for w in windows)
        monkeypatch.setattr(tpt, "sample_window", lambda gen, n, w: next(drawn))
        monkeypatch.setattr(tpt, "lumisphere_directions", lambda gen: dirs)

    feed()
    gd, gsh, _, mse = ttrain.cell_grads(tg, tr, torch.from_numpy(gt), torch.Generator())
    assert_close_of_scale(mse, mse_j, CELL_TOL, "mse")
    assert_close_of_scale(gd, gd_j, CELL_TOL, "grad density")
    assert_close_of_scale(gsh, gsh_j, CELL_TOL, "grad sh")

    feed()
    new_tg, new_trms, tstats = ttrain.train_step(tg, tpt.RMSState.from_numpy(rd, rs, device="cpu"), tr,
                                                 torch.from_numpy(gt), step, torch.Generator())
    assert_close_of_scale(tstats["loss"], jstats["loss"], CELL_TOL, "loss")
    for got, want, g, name in ((new_tg.density_data, new_jg.density_data, gd_j, "density"),
                               (new_tg.sh_data, new_jg.sh_data, gsh_j, "sh"),
                               (new_trms.rms_density, new_jrms.rms_density, gd_j, "rms_density"),
                               (new_trms.rms_sh, new_jrms.rms_sh, gsh_j, "rms_sh")):
        keep = np.abs(g) > 1e-3 * np.abs(g).max()
        assert keep.sum() > 50
        assert_close_of_scale(np_(got)[keep], np.asarray(want)[keep], CELL_TOL, name)
    out = ttrain.render_step(new_tg, tr)
    assert tuple(out["rgb"].shape) == (64, 3) and "depth" in out
