"""Data-parallel training in the port on two host ranks (gloo): the NeRF
trainer's mesh routes (autograd, fused MLP, fused train level) and the
row-sharded Plenoxels steps.

The two ranks run once for the whole file, in fresh processes
(``parallel/launch.py::run_ranks``), and every check reads their results
through the module fixture ``ranks``. The ranks import this module, so it
imports JAX only inside the functions that run in the test's own process.

- Each NeRF route with perturb=True, two ``scan_steps`` whose global
  batches are split over the two ranks (the same global indices on every
  rank), against one process on the same global batches: the first
  step's loss and gradients as Adam takes them (every rank draws the
  global batch's randoms, so the two see the same samples), both steps'
  losses, and the replicas' parameters equal bit for bit.
- The fused train level on two ranks against JAX's
  ``NeRFTrainer(mesh=make_mesh(2), use_mega=True)`` (its ``shard_map`` and
  ``psum``, the kernel in interpret mode), on the coarse level alone (no
  fine samples). JAX's interpret mode runs op by op, compiling each op,
  and the hierarchical route took 15–25 s alone and ~49 s in a loaded
  Tier-1 worker; one level takes about half. The fine level's mesh route
  is held to the one-process route above (perturb on), and that route to
  JAX's hierarchical one, fine depths fed to both, by
  ``tests/test_torch_train.py``.

The one-process side runs in the ranks' processes after the group's
work, half in each, so the test's own process computes only JAX's route
meanwhile.
- The row-sparse and packed touched steps on a row-sharded state against
  the one-process steps, by JAX's rule (tests/test_parallel.py:149-156),
  and ``gather_state_rows`` round-tripping ``shard_state_rows``.
"""
import numpy as np
import pytest
import torch

from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.ops import brick_grid as tbg
from nerf_projects_tpu_torch.ops import grid as tgrid
from nerf_projects_tpu_torch.parallel.launch import start_ranks
from nerf_projects_tpu_torch.train import plenoxels_sparse as ps
from nerf_projects_tpu_torch.train import plenoxels_trainer as tpt
from nerf_projects_tpu_torch.train.nerf_trainer import NeRFTrainer

W = 2
N_RAYS = 32          # the global batch: 16 rays a rank
N_SCAN = 2           # scan_steps per route
N_JAX = 64           # the batch against JAX's mesh route: test_torch_train.py's rays
ROUTES = {"autograd": {}, "fused": dict(use_fused_mlp=True), "mega": dict(use_fused_mlp=True, use_mega=True)}
# One process against two on the CPU differ only in the order of the
# gradient sums (two halves added by all_reduce)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5     # relative Frobenius norm, per tensor
# Plenoxels: tests/test_parallel.py's rule
MSE_RTOL = 1e-5
K_ROWS = 64          # max_touched: more than the 24^3 grid's 27 bricks
TRAINER_KW = dict(n_iters=1000, lambda_tv=512e-4, lambda_tv_sh=512e-3, lambda_beta=1e-3, lambda_sparsity=1e-6,
                  lr_sigma=3e1, lr_sigma_delay_steps=0, lr_sh=1e-2)
PLENOXEL_STEPS = 2


# ---------------------------------------------------------------------------
# Inputs (numpy, seeded; no JAX)
# ---------------------------------------------------------------------------

def nerf_cfg(perturb, num_fine_samples=8):
    return NeRFRenderConfig(num_coarse_samples=8, num_fine_samples=num_fine_samples, multires=10, multires_views=4,
                            use_viewdirs=True, white_bkgd=True, perturb=perturb)


def nerf_rays(n=N_RAYS, seed=3):
    d = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    target = np.random.default_rng(seed + 1).uniform(size=(n, 3)).astype(np.float32)
    return o, d, target


def as_rays(o, d):
    return Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(d))


def trainer(route, mesh=None, perturb=True, num_fine_samples=8):
    return NeRFTrainer(nerf_cfg(perturb, num_fine_samples), depth=8, width=256, mesh=mesh, device="cpu",
                       **ROUTES[route])


def scan(tr):
    """N_SCAN steps of ``scan_steps`` over a 64-ray pool from seed 0's
    state: the losses and PSNRs, the first step's gradients as Adam takes
    them, and the parameters after the steps."""
    po, pd, ptarget = nerf_rays(64, seed=7)
    state = tr.init_state(0)
    first, apply = [], tr.apply_grads

    def record(st, grads):
        if not first:
            first.append([None if g is None else {k: v.clone() for k, v in g.items()} for g in grads])
        return apply(st, grads)

    tr.apply_grads = record
    state, stats = tr.scan_steps(state, as_rays(po, pd), torch.from_numpy(ptarget), N_SCAN, batch_size=N_RAYS)
    return dict(loss=stats["loss"].tolist(), psnr=stats["psnr"].tolist(), grads=first[0],
                params=[{k: v.detach().clone() for k, v in m.state_dict().items()} for m in state.params])


def plenoxel_grid(reso=24, seed=0):
    """A seeded 24^3 sphere-bounded grid's BrickGrid (host)."""
    g = SparseGrid.create(reso, basis_dim=9, use_sphere_bound=True, device="cpu")
    rng = np.random.default_rng(seed)
    g.density_data.copy_(torch.from_numpy(rng.uniform(0.0, 6.0, (g.capacity, 1)).astype(np.float32)))
    g.sh_data.copy_(torch.from_numpy((rng.standard_normal((g.capacity, 27)) * 0.3).astype(np.float32)))
    return tbg.from_sparse_grid(g)


def tile_rays(n_tiles, th, tw, seed):
    """Coherent perspective tiles from cameras at radius 2.5 (the
    construction of tests/test_tile_march_pallas.py)."""
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
    o, d = (torch.from_numpy(np.stack(x).astype(np.float32)) for x in (os_, ds))
    return Rays(o, d, d)


def plenoxel_steps(kind, mesh=None):
    """PLENOXEL_STEPS steps of the sparse or packed touched step from a
    fresh state (row-sharded over ``mesh`` when given); the MSEs and the
    state after (gathered whole when sharded)."""
    bg = plenoxel_grid()
    tr = tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(step_size=0.5), device="cpu", **TRAINER_KW)
    st = ps.packed_state_from_grid(bg) if kind == "packed" else ps.sparse_state_from_grid(bg)
    step_fn = ps.train_step_tiles_packed_touched if kind == "packed" else ps.train_step_tiles_sparse
    out = {}
    if mesh is not None:
        whole = ps.pad_packed_state_rows(st, W) if kind == "packed" else ps.pad_state_rows(st, W)
        st = ps.shard_state_rows(st, mesh)
        back = ps.gather_state_rows(st, mesh)
        out["round_trip"] = all(torch.equal(back._asdict()[k], v) for k, v in whole._asdict().items()
                                if k != "cells" and v is not None)
        out["bytes"] = ps.state_bytes(st)
    else:
        out["bytes"] = ps.state_bytes(st)
    mses = []
    for i in range(PLENOXEL_STEPS):
        rays = tile_rays(2, 8, 16, seed=11 + i)
        target = torch.full(rays.origins.shape, 0.35)
        st, stats = step_fn(tr, bg, st, rays, target, i, torch.Generator().manual_seed(i), max_touched=K_ROWS,
                            mesh=mesh)
        mses.append(float(stats["mse"]))
    out["mse"] = mses
    out["state"] = ps.gather_state_rows(st, mesh) if mesh is not None else st
    return out


# ---------------------------------------------------------------------------
# What each rank runs (in its own process: no JAX here)
# ---------------------------------------------------------------------------

def rank_main(mega_case):
    """Every two-rank check of the file, in one group; the two ranks then
    share the same checks without a mesh (the one-process side)."""
    import torch.distributed as dist

    from nerf_projects_tpu_torch.models.nerf import flax_to_state_dict
    from nerf_projects_tpu_torch.parallel import make_mesh, shard_rays

    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    out = {route: scan(trainer(route, mesh)) for route in ROUTES}
    for kind in ("sparse", "packed"):
        out[kind] = plenoxel_steps(kind, mesh)

    # the fused train level's coarse level at JAX's parameters
    tr = trainer("mega", mesh, perturb=False, num_fine_samples=0)
    coarse = tr.init_params(0)[0]
    coarse.load_state_dict(flax_to_state_dict(mega_case["tree"]))
    o, d, target = nerf_rays(N_JAX)
    rays, tgt = shard_rays(mesh, (as_rays(o, d), torch.from_numpy(target)))
    (loss, mse), (grads, _) = tr._value_and_grad((coarse, None), None, rays, tgt)
    out["mega_jax"] = dict(loss=float(loss), mse=float(mse), grads={k: v.clone() for k, v in grads.items()})
    # the one-process side, split between the two processes
    rank = dist.get_rank()
    out["one"] = {route: scan(trainer(route)) for route in list(ROUTES)[rank::W]}
    out["one"].update({kind: plenoxel_steps(kind) for kind in ("sparse", "packed")[rank::W]})
    return out


# ---------------------------------------------------------------------------
# The test's process
# ---------------------------------------------------------------------------

def flax_tree(state_dict):
    """A NeRFMLP state dict -> the flax parameter tree (numpy) whose
    ``flax_to_state_dict`` it is."""
    p = {}
    for key, v in state_dict.items():
        layer, kind = key.rsplit(".", 1)
        leaf = p.setdefault(layer.replace("trunk.", "trunk_"), {})
        leaf["kernel" if kind == "weight" else "bias"] = v.numpy().T.copy() if kind == "weight" else v.numpy()
    return {"params": p}


@pytest.fixture(scope="module")
def mega_case():
    """The coarse model's parameters (seed 0's, biases drawn from N(0,
    0.2) by a seeded numpy generator, as test_torch_train.py's
    ``random_biases``) as a flax tree."""
    model = trainer("mega", perturb=False, num_fine_samples=0).init_params(0)[0]
    rng = np.random.default_rng(0)
    return dict(tree=flax_tree({k: (torch.from_numpy(rng.normal(0.0, 0.2, tuple(v.shape)).astype(np.float32))
                                    if k.endswith("bias") else v) for k, v in model.state_dict().items()}))


@pytest.fixture(scope="module")
def launched(mega_case):
    """The two ranks, started; they run while this process computes JAX's
    route and the one-process checks (``ranks`` joins them)."""
    return start_ranks("tests.test_torch_parallel_train:rank_main", W, dict(mega_case=mega_case))


@pytest.fixture(scope="module")
def jax_mega(mega_case, launched):
    """JAX's mesh route (``shard_map`` + ``psum``, the kernel in interpret
    mode) on a two-device mesh (of the 8 CPU devices), its coarse level on
    the rays of test_torch_train.py, op by op: jitted, XLA fuses the bf16
    products' neighbours and moves JAX's own gradients by more than the
    criterion allows (up to 5% of trunk.0.bias' entries beyond 1e-2 of
    scale, jitted against op by op)."""
    import jax
    import jax.numpy as jnp

    import nerf_projects_tpu.ops.pallas.fused_mlp as jfm
    import nerf_projects_tpu.ops.pallas.fused_train as jft
    from nerf_projects_tpu.core.rays import Rays as JaxRays
    from nerf_projects_tpu.models.pipeline import NeRFRenderConfig as JaxConfig
    from nerf_projects_tpu.parallel.mesh import make_mesh as jax_mesh
    from nerf_projects_tpu.train.nerf_trainer import NeRFTrainer as JaxTrainer

    kw = nerf_cfg(False, num_fine_samples=0)._asdict()
    jcfg = JaxConfig(**{k: kw[k] for k in ("num_coarse_samples", "num_fine_samples", "multires", "multires_views",
                                            "use_viewdirs", "white_bkgd", "perturb")})
    jtr = JaxTrainer(jcfg, depth=8, width=256, use_fused_mlp=True, use_mega=True, mesh=jax_mesh(W))
    o, d, target = nerf_rays(N_JAX)
    old = jfm.INTERPRET, jft.INTERPRET
    jfm.INTERPRET = jft.INTERPRET = True
    try:
        (loss, mse), (grads, _) = jtr._mega_value_and_grad(
            (jax.tree_util.tree_map(jnp.asarray, mega_case["tree"]), None), None,
            JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d)), jnp.asarray(target))
    finally:
        jfm.INTERPRET, jft.INTERPRET = old
    return dict(loss=float(loss), mse=float(mse), grads=jax.tree_util.tree_map(np.asarray, grads))


@pytest.fixture(scope="module")
def ranks(launched, jax_mega):
    return launched.join()


@pytest.fixture(scope="module")
def one_process(ranks):
    """The same checks without a mesh (computed in the ranks' processes
    after the group's work, half in each)."""
    return {**ranks[0]["one"], **ranks[1]["one"]}


def rel_frobenius(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("route", list(ROUTES))
def test_data_parallel_step_matches_one_process(ranks, one_process, route):
    """The first step's loss, PSNR and gradients on two ranks (after the
    all_reduce) equal one process's on the same global batch, randoms
    included (perturb=True)."""
    want = one_process[route]
    for r in ranks:
        got = r[route]
        np.testing.assert_allclose(got["loss"][0], want["loss"][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["psnr"][0], want["psnr"][0], rtol=LOSS_RTOL)
        for g_model, w_model in zip(got["grads"], want["grads"]):
            for name, w in w_model.items():
                assert rel_frobenius(g_model[name], w) < GRAD_RTOL, (route, name)


@pytest.mark.parametrize("route", list(ROUTES))
def test_data_parallel_scan_keeps_replicas_equal(ranks, one_process, route):
    """Both scan_steps on two ranks: the same global draws as one process
    (the losses agree), and the two replicas' parameters equal bit for
    bit after them."""
    a, b = (r[route] for r in ranks)
    assert a["loss"] == b["loss"]
    for pa, pb in zip(a["params"], b["params"]):
        for name in pa:
            assert torch.equal(pa[name], pb[name]), (route, name)
    np.testing.assert_allclose(a["loss"], one_process[route]["loss"], rtol=1e-4)


def test_mega_mesh_route_matches_jax(ranks, jax_mega):
    """The fused train level's coarse level on two ranks (K2 with
    n_rays_total the global count, the gradients all-reduced) against JAX's
    shard_map + psum route on a two-device mesh, by test_torch_train.py's
    criteria."""
    from nerf_projects_tpu_torch.models.nerf import flax_to_state_dict
    from tests.test_torch_train import _assert_trainer_grads_close

    for r in ranks:
        got = r["mega_jax"]
        np.testing.assert_allclose(got["loss"], jax_mega["loss"], rtol=3e-3)
        np.testing.assert_allclose(got["mse"], jax_mega["mse"], rtol=3e-3)
        _assert_trainer_grads_close({k: v.numpy() for k, v in got["grads"].items()},
                                    flax_to_state_dict(jax_mega["grads"]))


def mostly_equal(a, b, frac=0.995, rtol=1e-3, atol=1e-4):
    ok = np.isclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)
    assert ok.mean() > frac, f"only {ok.mean():.4f} close"


@pytest.mark.parametrize("kind", ["sparse", "packed"])
def test_row_sharded_plenoxels_step_matches_one_process(ranks, one_process, kind):
    """Two steps on a row-sharded state against one process: the MSE to
    1e-5 and the masters by JAX's rule; each rank held about half the
    float32 state; the cells every rank marches hold the gathered masters,
    and the two ranks' gathered states are the same."""
    want = one_process[kind]
    nb = plenoxel_grid().n_bricks
    for r in ranks:
        got = r[kind]
        np.testing.assert_allclose(got["mse"], want["mse"], rtol=MSE_RTOL, atol=1e-7)
        assert got["bytes"] < 0.6 * want["bytes"]
        masters = ("packed_k",) if kind == "packed" else ("density_k", "sh_k")
        for k in masters:
            mostly_equal(getattr(got["state"], k)[:nb + 1], getattr(want["state"], k))
        st = got["state"]  # the cells each rank marches hold its gathered masters
        cells = st.packed_k if kind == "packed" else ps._pack(st.density_k, st.sh_k, st.cells.dtype)
        assert torch.equal(st.cells[:nb + 1], cells[:nb + 1])
    a, b = (r[kind]["state"] for r in ranks)
    for k, v in a._asdict().items():
        assert torch.equal(v, b._asdict()[k]), (kind, k)


@pytest.mark.parametrize("kind", ["sparse", "packed"])
def test_gather_state_rows_round_trips(ranks, kind):
    assert all(r[kind]["round_trip"] for r in ranks)
