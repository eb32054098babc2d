"""The port's background and learned-basis training steps, the neighbour
links host op and the full-grid TV loss against the JAX package (CPU).

Two steps of ``train_step_bg`` and of ``train_step_with_basis`` (the 3D
texture and the MLP) on both sides, each from one state (the second from
JAX's state after the first, so that its RMSprop runs on a nonzero rms),
with JAX's TV windows fed to the port. The render under autograd is float32 on both sides, sums
in another order, so losses and gradients agree to CELL_TOL of scale; the
RMSprop updates are compared where the gradient is clear of noise (|g| >
1e-3 of its largest entry: a first RMSprop step is lr sign(g), so a
gradient within rounding of 0 may take either sign; ROADMAP "Limits of
comparison"), and clear of RMSprop's eps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.ops import background as jbgm
from nerf_projects_tpu.ops import basis as jbasis
from nerf_projects_tpu.ops import grid as jgrid
from nerf_projects_tpu.ops import tv as jtvc
from nerf_projects_tpu.train import plenoxels_trainer as jpt
from nerf_projects_tpu_torch.ops import background as tbgm
from nerf_projects_tpu_torch.ops import basis as tbasis
from nerf_projects_tpu_torch.ops import grid as tgrid
from nerf_projects_tpu_torch.ops.kernels import _build
from nerf_projects_tpu_torch.train import plenoxels_trainer as tpt
from nerf_projects_tpu_torch.utils import native
from tests.test_torch_tile_march import both, np_, random_grids, tile_rays

CELL_TOL = 1e-5  # of scale: the per-ray render under autograd, float32 sums in another order
KW = dict(n_iters=1000, lambda_tv=1e-3, tv_sparsity=0.05, lambda_tv_sh=1e-2, tv_sh_sparsity=0.05,
          lr_sigma=1.0, lr_sigma_delay_steps=0)  # lr_sigma 30 would make the grid opaque or empty in one step
STEPS = (3, 4)


def assert_close_of_scale(got, want, tol, what):
    got, want = np_(got).astype(np.float64), np.asarray(want).astype(np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err < tol, f"{what}: max |err| {err:.3e} of scale, tolerance {tol}"


def assert_update_close(got, want, g, what, plain_rmsprop=False):
    """Updated parameters where |g| is clear of noise, to CELL_TOL of
    scale: |g| above 1e-3 of its largest entry and, for the basis' and
    the background's RMSprop (no first-visit bootstrap), sqrt(1 - beta)
    |g| at least 100x its eps (1e-8), since below that the step lr g /
    (sqrt(rms) + eps) follows g's own rounding."""
    g = np_(g)
    keep = np.abs(g) > 1e-3 * np.abs(g).max()
    if plain_rmsprop:
        keep &= np.sqrt(0.05) * np.abs(g) > 100 * 1e-8
    assert keep.sum() >= min(20, g.size // 4), what
    assert_close_of_scale(np_(got)[keep], np.asarray(want)[keep], CELL_TOL, what)


def jax_windows(key, gs):
    """The cells JAX's _tv_grads samples with ``key`` (density, SH)."""
    k_tv, k_sh, _ = jax.random.split(key, 3)
    return [np.array(jtvc.sample_window(k, gs, max(int(0.05 * gs), 1))) for k in (k_tv, k_sh)]


def feed(monkeypatch, windows):
    drawn = iter(torch.from_numpy(w) for w in windows)
    monkeypatch.setattr(tpt, "sample_window", lambda gen, n, w: next(drawn))


@pytest.fixture(scope="module")
def case():
    jg, tg = random_grids(16, 4, seed=80, dens_hi=2.0)
    o, d, v = (x.reshape(-1, 3) for x in tile_rays(1, 8, 8, seed=81))
    jr, tr = both([o, d, v])
    gt = np.random.default_rng(82).uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    return jg, tg, jr, tr, gt


def port_state(jg, jrms):
    """The port's grid and rms from the JAX package's."""
    from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid

    tg = SparseGrid.from_numpy(np.asarray(jg.links), np.asarray(jg.density_data), np.asarray(jg.sh_data), jg.radius,
                               jg.center, jg.basis_dim, device="cpu")
    return tg, tpt.RMSState.from_numpy(jrms.rms_density, jrms.rms_sh, device="cpu")


def copy_tree(t):
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), t)


def test_train_step_bg_matches_jax_over_two_steps(case, monkeypatch):
    jg, tg, jr, tr, gt = case
    jtrain = jpt.PlenoxelsTrainer(jgrid.GridRenderOptions(), **KW)
    ttrain = tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(), device="cpu", **KW)
    jm = jbgm.BackgroundMSI.create(4, 8, inner_radius=3.0)
    jm = jm._replace(data=jm.data + jnp.asarray(np.random.default_rng(83).normal(0, 0.5, jm.data.shape), jnp.float32))
    tm = tbgm.BackgroundMSI.from_numpy(np.asarray(jm.data), jm.radii, device="cpu")
    jrms, trms = jtrain.init_rms(jg), ttrain.init_rms(tg)
    jrb, trb = jnp.zeros_like(jm.data), torch.zeros_like(tm.data)
    kw = dict(lr_bg_scale=0.1, lambda_tv_bg=1e-2)
    for step in STEPS:
        key = jax.random.PRNGKey(step)
        windows = jax_windows(key, 16 ** 3)
        feed(monkeypatch, windows)
        gd, gsh, gbg, loss, mse = ttrain.bg_grads(tg, tm, tr, torch.from_numpy(gt), torch.Generator(),
                                                  lambda_tv_bg=kw["lambda_tv_bg"])
        jg, jm, jrms, jrb, jst = jtrain.train_step_bg(copy_tree(jg), copy_tree(jm), copy_tree(jrms), jnp.array(jrb),
                                                      jr, jnp.asarray(gt), jnp.float32(step), key, **kw)
        feed(monkeypatch, windows)
        tg, tm, trms, trb, tst = ttrain.train_step_bg(tg, tm, trms, trb, tr, torch.from_numpy(gt), step,
                                                      torch.Generator(), **kw)
        assert_close_of_scale(tst["loss"], jst["loss"], CELL_TOL, "loss")
        assert_close_of_scale(tst["mse"], jst["mse"], CELL_TOL, "mse")
        assert_close_of_scale(loss, jst["loss"], CELL_TOL, "bg_grads' loss")
        assert_update_close(tg.density_data, jg.density_data, gd, f"step {step} density")
        assert_update_close(tg.sh_data, jg.sh_data, gsh, f"step {step} sh")
        assert_update_close(tm.data, jm.data, gbg, f"step {step} background", plain_rmsprop=True)
        assert_update_close(trb, jrb, gbg, f"step {step} background rms", plain_rmsprop=True)
        np.testing.assert_array_equal(tm.radii, jm.radii)
        # the next step from JAX's state on both sides (the rms no longer 0)
        tg, trms = port_state(jg, jrms)
        tm = tbgm.BackgroundMSI.from_numpy(np.asarray(jm.data), jm.radii, device="cpu")
        trb = torch.from_numpy(np.array(jrb))


@pytest.mark.parametrize("kind", ["texture", "mlp"])
def test_train_step_with_basis_matches_jax_over_two_steps(case, monkeypatch, kind):
    jg, tg, jr, tr, gt = case
    jtrain = jpt.PlenoxelsTrainer(jgrid.GridRenderOptions(), **KW)
    ttrain = tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(), device="cpu", **KW)
    if kind == "texture":
        btype, posenc = jbasis.BASIS_TYPE_3D_TEXTURE, 0
        jb = jbasis.reinit_learned_basis(jbasis.init_basis_3d(8, 4), jax.random.PRNGKey(0), init_type="sh")
        tb = torch.from_numpy(np.array(jb))
        jrb, trb = jnp.zeros_like(jb), torch.zeros_like(tb)
    else:
        btype, posenc = jbasis.BASIS_TYPE_MLP, 2
        jb = jbasis.init_basis_mlp(jax.random.PRNGKey(1), 4, mlp_width=16, mlp_posenc_size=posenc)
        tb = tbasis.mlp_params_from_numpy(jb, device="cpu")
        jrb = {k: jnp.zeros_like(v) for k, v in jb.items()}
        trb = {k: torch.zeros_like(v) for k, v in tb.items()}
    jrms, trms = jtrain.init_rms(jg), ttrain.init_rms(tg)
    kw = dict(basis_type=btype, mlp_posenc_size=posenc, lr_basis=1e-2)
    for step in STEPS:
        key = jax.random.PRNGKey(10 + step)
        windows = jax_windows(key, 16 ** 3)
        feed(monkeypatch, windows)
        gd, gsh, gb, loss, mse = ttrain.basis_grads(tg, tb, tr, torch.from_numpy(gt), torch.Generator(),
                                                    basis_type=btype, mlp_posenc_size=posenc)
        jg, jrms, jb, jrb, jst = jtrain.train_step_with_basis(copy_tree(jg), copy_tree(jrms), copy_tree(jb),
                                                              copy_tree(jrb), jr, jnp.asarray(gt), jnp.float32(step),
                                                              key, **kw)
        feed(monkeypatch, windows)
        tg, trms, tb, trb, tst = ttrain.train_step_with_basis(tg, trms, tb, trb, tr, torch.from_numpy(gt), step,
                                                              torch.Generator(), **kw)
        assert_close_of_scale(tst["loss"], jst["loss"], CELL_TOL, "loss")
        assert_close_of_scale(loss, jst["loss"], CELL_TOL, "basis_grads' loss")
        assert_update_close(tg.density_data, jg.density_data, gd, f"step {step} density")
        assert_update_close(tg.sh_data, jg.sh_data, gsh, f"step {step} sh")
        assert_update_close(trms.rms_sh, jrms.rms_sh, gsh, f"step {step} rms sh")
        pairs = [(tb, jb, gb, trb, jrb)] if kind == "texture" else [(tb[k], jb[k], gb[k], trb[k], jrb[k]) for k in jb]
        for got, want, g, got_r, want_r in pairs:
            if np.abs(np_(g)).max() == 0:  # the last bias of an MLP whose relus are all off
                continue
            assert_update_close(got, want, g, f"step {step} basis", plain_rmsprop=True)
            assert_update_close(got_r, want_r, g, f"step {step} basis rms", plain_rmsprop=True)
        # the next step from JAX's state on both sides (the rms no longer 0)
        tg, trms = port_state(jg, jrms)
        tb, trb = (tbasis.mlp_params_from_numpy(x, device="cpu") if kind == "mlp" else torch.from_numpy(np.array(x))
                   for x in (jb, jrb))


def test_bg_and_basis_steps_copy_no_host_numbers_to_their_device(case, monkeypatch):
    """After a first step, neither step builds a tensor from host numbers
    (on the card each such copy waits for the queue to drain): the MSI's
    radii and the grid's constants are device constants."""
    _, tg, _, tr, gt = case
    tr_ = tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(), device="cpu", **KW)
    tm = tbgm.BackgroundMSI.create(4, 8, device="cpu")
    tex = tbasis.reinit_learned_basis(tbasis.init_basis_3d(8, 4, device="cpu"))
    mlp = tbasis.init_basis_mlp(torch.Generator().manual_seed(0), 4, mlp_posenc_size=1)
    gen, target = torch.Generator().manual_seed(0), torch.from_numpy(gt)

    def steps(i):
        tr_.train_step_bg(tg, tm, tr_.init_rms(tg), torch.zeros_like(tm.data), tr, target, i, gen)
        tr_.train_step_with_basis(tg, tr_.init_rms(tg), tex, torch.zeros_like(tex), tr, target, i, gen,
                                  basis_type=tbasis.BASIS_TYPE_3D_TEXTURE)
        out = tr_.train_step_with_basis(tg, tr_.init_rms(tg), mlp, {k: torch.zeros_like(v) for k, v in mlp.items()},
                                        tr, target, i, gen, basis_type=tbasis.BASIS_TYPE_MLP, mlp_posenc_size=1)
        return out[-1]

    steps(0)
    copies = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            copies.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch, name, counted)
    stats = steps(1)
    monkeypatch.undo()
    assert copies == [] and bool(torch.isfinite(stats["mse"]))


def test_bg_and_basis_steps_reduce_the_loss(case):
    _, tg, _, tr, _ = case
    target = torch.full((64, 3), 0.3)
    tr_ = tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(), device="cpu", lr_sigma_delay_steps=0, n_iters=100)
    gen = torch.Generator().manual_seed(1)
    g, tm, rms, rb = tg, tbgm.BackgroundMSI.create(4, 8, device="cpu"), tr_.init_rms(tg), None
    rb = torch.zeros_like(tm.data)
    losses = []
    for i in range(6):
        g, tm, rms, rb, st = tr_.train_step_bg(g, tm, rms, rb, tr, target, i, gen)
        losses.append(float(st["mse"]))
    assert losses[-1] < losses[0] and np.isfinite(losses).all()


def random_links(seed):
    rng = np.random.default_rng(seed)
    _, tg = random_grids(16, 1, seed=seed)
    links = np_(tg.links).copy()
    drop = (links >= 0) & (rng.uniform(size=links.shape) < 0.3)
    links[drop] = -1
    active = links >= 0
    links[active] = rng.permutation(int(active.sum())).astype(np.int32)  # rows in no particular order
    return links


@pytest.mark.parametrize("seed", [84, 85])
def test_build_neighbor_links_native_equals_its_plain_version_and_jax(seed):
    links = random_links(seed)
    got = tpt.build_neighbor_links(torch.from_numpy(links))
    plain = tpt.neighbor_links_reference(links)
    assert got.dtype == np.int32 and got.shape == (int(links.max()) + 1, 3)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jpt.build_neighbor_links(links))
    assert (got == -1).any() and (got >= 0).any()


def test_the_host_op_is_built_by_gxx_from_the_port_s_source():
    assert [p.name for p in _build.sources("native_ops", suffix=".cpp")] == ["native_ops.cpp"]
    path = _build.build_host("native_ops").path
    assert path.parent == _build.BUILD_DIR and _build.digest("native_ops", flags=_build.GXX_FLAGS,
                                                             suffix=".cpp") in path.name
    assert native.build_neighbor_links(np.full((2, 2, 2), -1, np.int32), 1).tolist() == [[-1, -1, -1]]
    with pytest.raises(ValueError, match="outside"):  # the op would write past its output
        native.build_neighbor_links(np.arange(8, dtype=np.int32).reshape(2, 2, 2), 4)
    with pytest.raises(ValueError, match="X, Y, Z"):
        native.build_neighbor_links(np.zeros((2, 2), np.int32), 1)


def test_tv_loss_matches_jax():
    links = random_links(86)
    cap = int(links.max()) + 1
    data = np.random.default_rng(87).standard_normal((cap, 5)).astype(np.float32)
    nbr = tpt.build_neighbor_links(links)
    want = jpt.tv_loss(jnp.asarray(data), jnp.asarray(nbr))
    assert_close_of_scale(tpt.tv_loss(torch.from_numpy(data), nbr), want, 1e-6, "tv_loss")
    assert_close_of_scale(tpt.tv_loss(torch.from_numpy(data), torch.from_numpy(nbr)), want, 1e-6, "tv_loss")
