"""The port's row-sparse Plenoxels steps (``train/plenoxels_sparse.py``)
on the CPU, through the plain versions of K3 and K4.

Within the port, each step is held against the one JAX's tests
(``tests/test_sparse_step.py``) pair it with: the sparse and touched steps
against the dense steps, the lazy b^D decay against the dense per-step
decay, the dense sweep against the touched step under per-visit RMSprop.
Across the packages, JAX's touched step (lazy, and per-visit with the
dense sweep) and its sparse step (their Pallas kernels in interpret mode)
and the port's take two steps from one state with the TV windows JAX
draws; JAX's K3 rounds its trilinear weights to bf16, so the states are
held to the fraction that JAX's own tests allow a bf16 march against a
float32 one (``JAX_FRAC``).

The port's K4 flags only the bricks it adds a gradient into, where JAX
flags every brick of its march windows: a row flagged with a zero
gradient gets its lazy decay early and its ``last_step`` stamp, nothing
else. So the lazy states' rms are compared as the dense recursion would
hold them now, rms b^(step - last_step) (``rms_now``)."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_projects_tpu.ops.pallas.tile_march as jtm
from nerf_projects_tpu.ops import brick_grid as jbg
from nerf_projects_tpu.ops import grid as jgrid
from nerf_projects_tpu.ops import tv_bricks as jtv
from nerf_projects_tpu.train import plenoxels_sparse as jps
from nerf_projects_tpu.train import plenoxels_trainer as jpt
from nerf_projects_tpu_torch.ops import brick_grid as tbg
from nerf_projects_tpu_torch.ops import grid as tgrid
from nerf_projects_tpu_torch.ops.kernels import dense_sweep as dsw
from nerf_projects_tpu_torch.ops.kernels import flat_train as tft
from nerf_projects_tpu_torch.ops.kernels import tile_march as ttm
from nerf_projects_tpu_torch.train import plenoxels_sparse as ps
from nerf_projects_tpu_torch.train import plenoxels_trainer as tpt
from tests.test_torch_tile_march import both, np_, random_grids, tile_rays

MSE_RTOL = 1e-5  # the first step's MSE; tests/test_sparse_step.py's
K_ROWS = 64      # max_touched: more than the 24^3 grids' 27 bricks (JAX's tests take 4096, 16 MB a row block here)
# The MSE across the packages: JAX's K3 rounds its trilinear weights to
# bf16 (its twin's construction), the port's plain version does not;
# 2.4e-4 apart on the first step here
JAX_MSE_RTOL = 2e-3
# ... and so their gradients differ by up to ~1e-2 of scale, and RMSprop's
# first update, lr sign(g), flips on the cells whose gradient is that
# small: the states across the packages are held to the fraction that
# tests/test_sparse_step.py:170-171 allows a bf16 march against a float32
# one (0.9836-0.9851 of the entries close here)
JAX_FRAC = 0.98


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the plain versions' index_add_ sums in a fixed
    order, and the small ops do not wait on oversubscribed threads among
    the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# TV lambdas x512, as tests/test_sparse_step.py: the TV gradient is
# normalised by the sampled cells, one brick at these grids
TRAINER_KW = dict(n_iters=1000, lambda_tv=512e-4, lambda_tv_sh=512e-3, lambda_beta=1e-3, lambda_sparsity=1e-6,
                  lr_sigma=3e1, lr_sigma_delay_steps=0, lr_sh=1e-2)


def make_trainer(**kw):
    return tpt.PlenoxelsTrainer(tgrid.GridRenderOptions(step_size=0.5), device="cpu", **{**TRAINER_KW, **kw})


def port_bg(reso=24, seed=0):
    return tbg.from_sparse_grid(random_grids(reso, 9, seed=seed)[1])


def batch(seed, n_tiles=2):
    rays = both(tile_rays(n_tiles, 8, 16, seed=seed))[1]
    return rays, torch.full(rays.origins.shape, 0.35)


def gen(i):
    return torch.Generator().manual_seed(i)


def mostly_equal(a, b, frac=0.995, rtol=1e-3, atol=1e-4):
    """tests/test_sparse_step.py's rule: the scatter order differs between
    the paths and RMSprop's scale-free update amplifies it on cells whose
    gradient nearly cancels."""
    ok = np.isclose(np_(a), np_(b), rtol=rtol, atol=atol)
    assert ok.mean() > frac, f"only {ok.mean():.4f} close"


def rms_now(rms, last_step, step, beta):
    """A lazy state's rms as the dense recursion holds it after ``step``:
    rms b^(step - last_step) on the rows ever touched."""
    rms, last = np_(rms).astype(np.float64), np_(last_step)
    decay = np.where(last >= 0, beta ** (step - last).astype(np.float64), 1.0)
    return rms * decay.reshape((-1,) + (1,) * (rms.ndim - 1))


def packed_parts(st, nb):
    """A packed state's (density [nb, 512], SH [nb, 512, 3B], rms density,
    rms SH) in the brick layout."""
    B = st.basis_dim
    return (st.packed_k[:nb, :, 0], st.packed_k[:nb, :, 1:1 + 3 * B], st.rms[:nb, :, 0],
            st.rms[:nb, :, 1:1 + 3 * B])


# ---------------------------------------------------------------------------
# Against the port's dense steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optim", ["rmsprop", "sgd"])
def test_sparse_step_matches_the_dense_step(optim):
    """TestSparseStep._run_pair: the sparse step against
    train_step_tiles_pallas over steps with disjoint rays, so rows go
    untouched between steps (the b^D decay)."""
    trainer = make_trainer(**({} if optim == "rmsprop" else dict(sigma_optim="sgd", sh_optim="sgd")))
    bg = port_bg(24, seed=0)
    st = ps.sparse_state_from_grid(bg)
    rms = trainer.init_rms_bricks(bg)
    n_steps = 3 if optim == "rmsprop" else 2
    for i in range(n_steps):
        rays, target = batch(100 + 7 * i)
        st, s = ps.train_step_tiles_sparse(trainer, bg, st, rays, target, i, gen(i))
        bg, rms, d = trainer.train_step_tiles_pallas(bg, rms, rays, target, i, gen(i))
        assert float(s["touched_overflow"]) == 0.0
        np.testing.assert_allclose(float(s["mse"]), float(d["mse"]), rtol=MSE_RTOL, atol=1e-7)
    out = ps.grid_from_sparse_state(bg, st)
    mostly_equal(out.density_bricks, bg.density_bricks)
    mostly_equal(out.sh_bricks, bg.sh_bricks)
    nb = bg.n_bricks
    last = st.last_step[:nb]
    mostly_equal(rms_now(st.rms_density[:nb], last, n_steps - 1, trainer.rms_beta), rms.rms_density)
    mostly_equal(rms_now(st.rms_sh[:nb], last, n_steps - 1, trainer.rms_beta), rms.rms_sh)
    assert int(st.last_step[nb]) == -1 and not st.density_k[nb].any() and not st.sh_k[nb].any()


def test_sparse_overflow_reported():
    trainer = make_trainer()
    st = ps.sparse_state_from_grid(bg := port_bg(24, seed=1))
    rays, target = batch(3)
    st2, stats = ps.train_step_tiles_sparse(trainer, bg, st, rays, target, 0, gen(0), max_touched=2)
    assert float(stats["touched_overflow"]) > 0.0
    assert bool(torch.isfinite(st2.density_k).all())


@pytest.mark.parametrize("step_name,what", [("sparse", "sparse step"), ("packed", "packed step"),
                                            ("touched", "packed step"), ("dense_k", "kernel-layout step")])
@pytest.mark.parametrize("reg", ["lambda_l2_sh", "lambda_tv_lumisphere"])
def test_unsupported_regularizers_raise(step_name, what, reg):
    trainer = make_trainer(**{reg: 1e-3})
    bg = port_bg(16, seed=2)
    rays, target = batch(4, n_tiles=1)
    st = ps.packed_state_from_grid(bg) if step_name in ("packed", "touched") else ps.sparse_state_from_grid(bg)
    fn = {"sparse": ps.train_step_tiles_sparse, "packed": ps.train_step_tiles_packed,
          "touched": ps.train_step_tiles_packed_touched, "dense_k": ps.train_step_tiles_dense_k}[step_name]
    with pytest.raises(ValueError, match=what):
        fn(trainer, bg, st, rays, target, 0, gen(0))


def test_dense_k_matches_the_sparse_and_the_dense_steps():
    """TestDenseKernelLayoutStep: the kernel-layout dense step against
    the sparse step on the same float32 masters (shared_kernel_arrays)
    and, at the bf16 forward's tolerance, the brick-layout dense step."""
    trainer = make_trainer()
    bg = port_bg(24, seed=5)
    st = ps.sparse_state_from_grid(bg, shared_kernel_arrays=True)
    st_sp = ps.sparse_state_from_grid(bg, shared_kernel_arrays=True)
    assert st.cells is None and st.density_z is None
    dense_bg, rms = bg, trainer.init_rms_bricks(bg)
    for i in range(3):
        rays, target = batch(300 + 11 * i)
        st, k = ps.train_step_tiles_dense_k(trainer, bg, st, rays, target, i, gen(i))
        st_sp, s = ps.train_step_tiles_sparse(trainer, bg, st_sp, rays, target, i, gen(i))
        dense_bg, rms, d = trainer.train_step_tiles_pallas(dense_bg, rms, rays, target, i, gen(i))
        np.testing.assert_allclose(float(k["mse"]), float(s["mse"]), rtol=MSE_RTOL, atol=1e-7)
        np.testing.assert_allclose(float(k["mse"]), float(d["mse"]), rtol=3e-3)
    mostly_equal(st.density_k, st_sp.density_k)
    mostly_equal(st.sh_k, st_sp.sh_k)
    mostly_equal(st.rms_density, rms_now(st_sp.rms_density, st_sp.last_step, 2, trainer.rms_beta))
    mostly_equal(ps.grid_from_sparse_state(dense_bg, st).density_bricks, dense_bg.density_bricks, frac=0.98)


def test_packed_matches_dense_k():
    """TestPackedStep: the packed dense step against the kernel-layout one,
    both marching float32 masters."""
    trainer = make_trainer()
    bg = port_bg(24, seed=6)
    st_k = ps.sparse_state_from_grid(bg, shared_kernel_arrays=True)
    st_p = ps.packed_state_from_grid(bg)
    assert st_p.cells is None and st_p.basis_dim == 9
    for i in range(3):
        rays, target = batch(500 + 3 * i)
        st_p, p = ps.train_step_tiles_packed(trainer, bg, st_p, rays, target, i, gen(i))
        st_k, k = ps.train_step_tiles_dense_k(trainer, bg, st_k, rays, target, i, gen(i))
        np.testing.assert_allclose(float(p["mse"]), float(k["mse"]), rtol=MSE_RTOL, atol=1e-7)
    nb = bg.n_bricks
    d, sh, rd, rs = packed_parts(st_p, nb)
    mostly_equal(d, st_k.density_k[:nb])
    mostly_equal(sh, st_k.sh_k[:nb])
    mostly_equal(rd, st_k.rms_density[:nb])
    mostly_equal(rs, st_k.rms_sh[:nb])
    assert not st_p.packed_k[..., 28:].any() and not st_p.packed_k[nb].any()  # padding and sentinel
    out = ps.grid_from_packed_state(bg, st_p)
    assert out.density_bricks.shape == bg.density_bricks.shape and bool(torch.isfinite(out.sh_bricks).all())


def test_bf16_rms_tracks_float32_rms():
    trainer = make_trainer()
    bg = port_bg(24, seed=9)
    st32 = ps.sparse_state_from_grid(bg)
    st16 = ps.sparse_state_from_grid(bg, rms_dtype=torch.bfloat16)
    assert st16.rms_sh.dtype == torch.bfloat16
    rays, target = batch(21)
    for i in range(2):
        st32, _ = ps.train_step_tiles_sparse(trainer, bg, st32, rays, target, i, gen(i))
        st16, _ = ps.train_step_tiles_sparse(trainer, bg, st16, rays, target, i, gen(i))
    a, b = np_(st16.density_k), np_(st32.density_k)
    scale = np.abs(b).max() + 1e-12
    assert np.isclose(a / scale, b / scale, rtol=0, atol=2e-2).mean() > 0.99


def test_shared_kernel_arrays_match_the_bf16_copy():
    """Marching the float32 masters (no copy) against the bf16 copy: the
    same steps to bf16 tolerance; the copy is rewritten on touched rows
    only and stays the bf16 rounding of the masters."""
    trainer = make_trainer()
    bg = port_bg(24, seed=15)
    st_c = ps.sparse_state_from_grid(bg)
    st_s = ps.sparse_state_from_grid(bg, shared_kernel_arrays=True)
    assert st_c.cells.dtype == torch.bfloat16 and st_s.cells is None
    rays, target = batch(31)
    for i in range(2):
        st_c, _ = ps.train_step_tiles_sparse(trainer, bg, st_c, rays, target, i, gen(i))
        st_s, _ = ps.train_step_tiles_sparse(trainer, bg, st_s, rays, target, i, gen(i))
    a, b = np_(st_s.density_k), np_(st_c.density_k)
    scale = np.abs(b).max() + 1e-12
    assert np.isclose(a / scale, b / scale, rtol=0, atol=2e-2).mean() > 0.99
    torch.testing.assert_close(st_c.density_z, st_c.density_k.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(st_c.sh_z, st_c.sh_k.bfloat16(), rtol=0, atol=0)


def test_touched_step_matches_the_packed_dense_update():
    """TestPackedTouchedStep: the touched-row step against the packed
    dense step over four steps with disjoint rays; its bf16 copy stays
    the bf16 rounding of its masters."""
    trainer = make_trainer()
    bg = port_bg(24, seed=9)
    st_d = ps.packed_state_from_grid(bg)
    st_t = ps.packed_state_from_grid(bg)
    for i in range(4):
        rays, target = batch(900 + 11 * i)
        st_t, t = ps.train_step_tiles_packed_touched(trainer, bg, st_t, rays, target, i, gen(i), max_touched=K_ROWS)
        st_d, d = ps.train_step_tiles_packed(trainer, bg, st_d, rays, target, i, gen(i))
        np.testing.assert_allclose(float(t["mse"]), float(d["mse"]), rtol=MSE_RTOL, atol=1e-7)
        assert float(t["touched_overflow"]) == 0.0
    np.testing.assert_allclose(np_(st_t.packed_k), np_(st_d.packed_k), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rms_now(st_t.rms, st_t.last_step, 3, trainer.rms_beta), np_(st_d.rms),
                               rtol=1e-4, atol=1e-5)


def test_touched_step_with_a_bf16_copy_matches_the_dense_step():
    """The card's configuration on the host: the touched step's
    incrementally rewritten bf16 copy against train_step_tiles_pallas,
    which rebuilds its bf16 cells every step (the same forward)."""
    trainer = make_trainer()
    bg = port_bg(24, seed=8)
    st = ps.packed_state_from_grid(bg, bf16_cells=True)
    rms = trainer.init_rms_bricks(bg)
    for i in range(3):
        rays, target = batch(40 + i)
        st, t = ps.train_step_tiles_packed_touched(trainer, bg, st, rays, target, i, gen(i), max_touched=64)
        bg, rms, d = trainer.train_step_tiles_pallas(bg, rms, rays, target, i, gen(i))
        np.testing.assert_allclose(float(t["mse"]), float(d["mse"]), rtol=MSE_RTOL, atol=1e-7)
    torch.testing.assert_close(st.cells, st.packed_k.bfloat16(), rtol=0, atol=0)
    nb = bg.n_bricks
    d, sh, rd, rs = packed_parts(st, nb)
    mostly_equal(d, bg.density_bricks)
    mostly_equal(sh, bg.sh_bricks)
    mostly_equal(rms_now(st.rms[:nb], st.last_step[:nb], 2, trainer.rms_beta)[..., 0], rms.rms_density)


def test_pervisit_rms_ignores_the_gap_between_touches():
    """Per-visit RMSprop: a second step at global step 1 or 500 gives the
    same state (constant learning rates); the literal b^D semantics do
    not."""
    bg = port_bg(24, seed=12)
    rays, target = batch(55)
    lr_kw = dict(lr_sigma=1.0, lr_sigma_final=1.0, lr_sh=1e-2, lr_sh_final=1e-2)

    def two_steps(trainer, second):
        st = ps.packed_state_from_grid(bg)
        st, _ = ps.train_step_tiles_packed_touched(trainer, bg, st, rays, target, 0, gen(3), max_touched=K_ROWS)
        st, _ = ps.train_step_tiles_packed_touched(trainer, bg, st, rays, target, second, gen(3), max_touched=K_ROWS)
        return np_(st.packed_k)

    pv = make_trainer(rms_pervisit=True, **lr_kw)
    a, b = two_steps(pv, 1), two_steps(pv, 500)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    c = two_steps(make_trainer(rms_pervisit=False, **lr_kw), 500)
    assert not np.allclose(b, c, rtol=1e-4, atol=1e-5)


def test_touched_overflow_reported():
    trainer = make_trainer()
    bg = port_bg(24, seed=10)
    st = ps.packed_state_from_grid(bg)
    rays, target = batch(31)
    st, stats = ps.train_step_tiles_packed_touched(trainer, bg, st, rays, target, 0, gen(0), max_touched=8)
    assert float(stats["touched_overflow"]) > 0.0
    assert bool(torch.isfinite(st.packed_k).all())


def test_touched_step_with_the_tpu_schedule_knobs_matches_the_plain_one():
    """TestTileReducedTouchedStep: wps and tile_rows change nothing (the
    port has no per-window blocks to pre-reduce): the same bits."""
    trainer = make_trainer()
    bg = port_bg(24, seed=40)
    st_a = ps.packed_state_from_grid(bg)
    st_b = ps.packed_state_from_grid(bg)
    for i in range(3):
        rays, target = batch(700 + 3 * i)
        kt = ps.required_tile_rows(bg, rays, trainer.opts) if i == 0 else 16
        assert kt % 16 == 0 and kt > 0
        st_a, a = ps.train_step_tiles_packed_touched(trainer, bg, st_a, rays, target, i, gen(i), max_touched=K_ROWS)
        st_b, b = ps.train_step_tiles_packed_touched(trainer, bg, st_b, rays, target, i, gen(i), max_touched=K_ROWS,
                                                     wps=4, tile_rows=kt)
        assert float(a["mse"]) == float(b["mse"]) and int(b["dropped_tile_rows"]) == 0
    torch.testing.assert_close(st_a.packed_k, st_b.packed_k, rtol=0, atol=0)
    torch.testing.assert_close(st_a.rms, st_b.rms, rtol=0, atol=0)


def test_tile_segment_reduce_equals_the_scatter():
    """tile_segment_reduce against a scatter-add of the same blocks, and
    the rows beyond k_tile reported."""
    rng = np.random.default_rng(41)
    nb, T, C = 30, 3, 5
    rows = torch.from_numpy(rng.integers(0, nb + 1, (T, C, 8)).astype(np.int32))  # nb: no row
    blocks = torch.from_numpy(rng.standard_normal((T, C, 8, 4, 6)).astype(np.float32))

    def scat(b, r):
        acc = torch.zeros((nb + 1, 4, 6))
        acc.index_add_(0, r.reshape(-1).long(), b.reshape(-1, 4, 6))
        return acc[:nb]

    need = max(int(torch.unique(rows[t][rows[t] != nb]).numel()) for t in range(T))
    trows, tacc, dropped = ps.tile_segment_reduce(blocks, rows, nb, need)
    assert int(dropped) == 0 and trows.dtype == torch.int32
    torch.testing.assert_close(scat(tacc, trows), scat(blocks, rows), rtol=1e-6, atol=1e-6)
    assert int(ps.tile_segment_reduce(blocks, rows, nb, need - 2)[2]) > 0


def test_flat_fused_grads_are_the_occupancy_clipped_ones():
    """TestFlatWindowStep: fused_grad_blocks_flat marches what
    fused_grad_blocks marches with the occupancy clip: the same bits,
    nothing dropped, and it needs prebuilt kernel arrays."""
    bg = port_bg(24, seed=50)
    rays, _ = batch(51, n_tiles=3)
    gt = torch.full(rays.origins.shape, 0.4)
    opts = tgrid.GridRenderOptions(step_size=0.5)
    st = ps.packed_state_from_grid(bg)
    want = ttm.fused_grad_blocks(bg, rays, gt, opts, kernel_arrays=st.packed_k, use_occupancy=True,
                                 beta_loss=1e-3, sparsity_loss=1e-4)
    wc = tft.required_windows(bg, rays, opts)
    assert wc > 0
    got = tft.fused_grad_blocks_flat(bg, rays, gt, opts, kernel_arrays=st.packed_k, w_cap=wc, beta_loss=1e-3,
                                     sparsity_loss=1e-4)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert torch.equal(got[2], want[2]) and int(got[3]["dropped_windows"]) == 0
    with pytest.raises(ValueError, match="kernel arrays"):
        tft.fused_grad_blocks_flat(bg, rays, gt, opts, kernel_arrays=None, w_cap=wc)


def test_flat_touched_step_matches_the_occupancy_clipped_one():
    trainer = make_trainer()
    bg = port_bg(24, seed=52)
    st_a = ps.packed_state_from_grid(bg)
    st_b = ps.packed_state_from_grid(bg)
    for i in range(3):
        rays, target = batch(800 + 3 * i)
        wc = tft.required_windows(bg, rays, trainer.opts)
        st_a, a = ps.train_step_tiles_packed_touched(trainer, bg, st_a, rays, target, i, gen(i), max_touched=K_ROWS,
                                                     use_occupancy=True)
        st_b, b = ps.train_step_tiles_packed_touched(trainer, bg, st_b, rays, target, i, gen(i), max_touched=K_ROWS,
                                                     flat_windows=wc)
        assert float(a["mse"]) == float(b["mse"]) and int(b["dropped_active_chunks"]) == 0
    torch.testing.assert_close(st_a.packed_k, st_b.packed_k, rtol=0, atol=0)
    torch.testing.assert_close(st_a.rms, st_b.rms, rtol=0, atol=0)
    with pytest.raises(ValueError, match="tile_rows"):
        ps.train_step_tiles_packed_touched(trainer, bg, st_a, rays, target, 3, gen(3), flat_windows=wc, tile_rows=16)


def test_required_touched_rows_leave_no_overflow():
    trainer = make_trainer()
    bg = port_bg(24, seed=57)
    st = ps.packed_state_from_grid(bg)
    rays, target = batch(58, n_tiles=3)
    nb = bg.n_bricks
    tv_w = max(int(trainer.tv_sparsity * nb), 1) + max(int(trainer.tv_sh_sparsity * nb), 1)
    k = ps.required_touched_rows(bg, rays, trainer.opts, tv_rows=4 * tv_w, multiple=16)
    assert 0 < k <= nb + 16 + 4 * tv_w
    for kwargs in ({"use_occupancy": True}, {"flat_windows": tft.required_windows(bg, rays, trainer.opts)}):
        _, stats = ps.train_step_tiles_packed_touched(trainer, bg, st, rays, target, 0, gen(9), max_touched=k,
                                                      **kwargs)
        assert float(stats["touched_overflow"]) == 0.0


@pytest.mark.parametrize("case", ["pervisit", "flat-pervisit", "flat-sgd"])
def test_dense_optim_matches_the_touched_step(case):
    """TestDenseOptimStep: the dense where(g == 0) sweep against the
    touched-row optimizer under per-visit RMSprop or SGD."""
    trainer = make_trainer(**(dict(sigma_optim="sgd", sh_optim="sgd") if case.endswith("sgd")
                              else dict(rms_pervisit=True)))
    bg = port_bg(24, seed=21 if case == "pervisit" else 23)
    st_t = ps.packed_state_from_grid(bg)
    st_d = ps.packed_state_from_grid(bg)
    n = 3 if case == "pervisit" else 2
    for i in range(n):
        rays, target = batch(210 + 7 * i if case == "pervisit" else 77)
        kw = {"flat_windows": tft.required_windows(bg, rays, trainer.opts)} if case.startswith("flat") else {}
        st_t, t = ps.train_step_tiles_packed_touched(trainer, bg, st_t, rays, target, i, gen(i), max_touched=K_ROWS,
                                                     **kw)
        st_d, d = ps.train_step_tiles_packed_touched(trainer, bg, st_d, rays, target, i, gen(i), max_touched=K_ROWS,
                                                     dense_optim=True, **kw)
        assert float(t["mse"]) == float(d["mse"])
    np.testing.assert_allclose(np_(st_t.packed_k), np_(st_d.packed_k), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(st_t.rms), np_(st_d.rms), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(st_t.last_step, st_d.last_step, rtol=0, atol=0)


def test_defer_split_is_bit_identical():
    trainer = make_trainer(rms_pervisit=True)
    bg = port_bg(24, seed=29)
    st_f = ps.packed_state_from_grid(bg, bf16_cells=True)
    st_s = ps.packed_state_from_grid(bg, bf16_cells=True)
    for i in range(3):
        rays, target = batch(290 + 3 * i)
        st_f, f = ps.train_step_tiles_packed_touched(trainer, bg, st_f, rays, target, i, gen(i), dense_optim=True)
        st_mid, s = ps.train_step_tiles_packed_touched(trainer, bg, st_s, rays, target, i, gen(i),
                                                       dense_optim="defer")
        assert st_mid is st_s  # the state flows through unchanged
        st_s = ps.dense_sweep_apply(trainer, bg, st_s, s["dense_acc"], s["touched_flag"], i)
        assert float(f["mse"]) == float(s["mse"])
    for a, b in zip(st_f, st_s):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.int32: torch.int32}


def same_bits(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got.view(BITS[got.dtype]), want.view(BITS[want.dtype])), what


def accumulator_sweep(trainer, bg, st, gd, gsh, tv, flag, step):
    """The touched step's dense sweep as it was before the one-pass sweep:
    a dense packed accumulator of K4's arrays and the TV blocks, masked,
    per-visit RMSprop or SGD over it, where(g == 0) keeping the old bits."""
    nb, B = bg.n_bricks, st.basis_dim
    acc = torch.zeros(st.packed_k.shape)
    acc[:nb, :, 0] = gd
    acc[:nb, :, 1:1 + 3 * B] = gsh
    for r4, blk in zip(*ps.pack_tv_blocks(tv, B)):
        acc.index_add_(0, r4, blk)
    g = acc * torch.cat([bg.cell_mask.float(), torch.zeros(1, 512)])[..., None]
    pk, rms_old, b = st.packed_k, st.rms.float(), trainer.rms_beta
    if trainer.sigma_optim == "rmsprop":
        rms = torch.where(g == 0.0, rms_old, torch.where(rms_old == 0.0, g * g, b * rms_old + (1.0 - b) * g * g))
        x = g / (torch.sqrt(rms) + 1e-8)
    else:
        rms, x = rms_old, g
    upd = x * trainer.lr_sh_fn(step)
    upd[..., 0] = x[..., 0] * trainer.lr_sigma_fn(step)
    new = pk - upd
    if trainer.density_minval > -1e8:
        new[..., 0] = torch.clamp(new[..., 0], min=trainer.density_minval)
    new = torch.where(g == 0.0, pk, new)
    last = torch.where(flag == 1, int(step), st.last_step)
    last[nb] = -1
    return new, rms.to(st.rms.dtype), new.to(torch.bfloat16), last


@pytest.mark.parametrize("optim, rms_dtype", [("pervisit", torch.float32), ("pervisit", torch.bfloat16),
                                              ("sgd", torch.float32)])
def test_one_pass_sweep_is_the_accumulator_sweep_bit_for_bit(optim, rms_dtype):
    """The plain one-pass sweep on K4's arrays with the TV added in place
    against the accumulator arithmetic it replaced, on a second step (rms
    zero on the cells first visited now, nonzero on the others), with TV
    on (rows without a neighbour among its blocks) and a density floor
    that binds."""
    trainer = make_trainer(density_minval=1.0, **(dict(sigma_optim="sgd", sh_optim="sgd") if optim == "sgd"
                                                  else dict(rms_pervisit=True)))
    bg = port_bg(24, seed=31)
    nb, B = bg.n_bricks, 9
    st = ps.packed_state_from_grid(bg, rms_dtype=rms_dtype, bf16_cells=True)
    rays, target = batch(310)
    st, _ = ps.train_step_tiles_packed_touched(trainer, bg, st, rays, target, 0, gen(0), dense_optim=True)
    rays, target = batch(311)
    _, (gd, gsh), touched, _ = ps._march(trainer, bg, ps._packed_cells(st), rays, target)
    tv = ps._tv_parts(trainer, bg, st.packed_k[..., :1].__getitem__, st.packed_k[..., 1:1 + 3 * B].__getitem__,
                      gen(1))
    assert {k for k, _, _ in tv} == {"d", "s"} and any(bool((r4 == nb).any()) for _, r4, _ in tv)
    flag = touched.clone()
    for _, r4, _ in tv:
        flag.index_fill_(0, r4, 1)
    want = accumulator_sweep(trainer, bg, st, gd, gsh, tv, flag, 1)
    gd2, gsh2 = gd.clone(), gsh.clone()
    ps._add_tv(gd2, gsh2, tv)
    got = ps.dense_sweep_apply(trainer, bg, st, (gd2, gsh2), flag, 1)
    for name, a, b in zip(("packed_k", "rms", "cells", "last_step"), (got.packed_k, got.rms, got.cells,
                                                                       got.last_step), want):
        same_bits(a, b, name)
    assert bool(((want[0][:nb, :, 0] == 1.0) & (st.packed_k[:nb, :, 0] != 1.0)).any())  # the floor binds
    if optim != "sgd":
        rms = st.rms[:nb, :, :1 + 3 * B][bg.cell_mask]
        assert bool((rms == 0).any()) and bool((rms != 0).any())


def sweep_inputs(nb=6, B=4, rms_dtype=torch.float32, seed=3):
    """A random packed state [nb + 1, 512, CP] with values on its padding
    channels, masked cells and sentinel row too, rms zero on a third of
    its elements, K4-shaped gradients with exact zeros on live cells, a
    mask, flags and stamps."""
    g = torch.Generator().manual_seed(seed)
    cp = ttm.channels(B)
    packed = torch.randn((nb + 1, 512, cp), generator=g)
    rms = torch.rand((nb + 1, 512, cp), generator=g).to(rms_dtype)
    rms[:, ::3] = 0
    gd, gsh = torch.randn((nb, 512), generator=g), torch.randn((nb, 512, 3 * B), generator=g)
    gd[:, ::7] = 0
    gsh[:, ::5] = 0
    mask = torch.rand((nb, 512), generator=g) > 0.3
    flag = (torch.rand(nb + 1, generator=g) > 0.5).int()
    flag[nb] = 1
    last = torch.randint(-1, 10, (nb + 1,), generator=g, dtype=torch.int32)
    return [packed, rms, gd, gsh, mask, flag, last]


SWEEP_NUMBERS = dict(step=11, lr_sigma=30.0, lr_sh=1e-2, beta=0.95, density_minval=-1e9)


@pytest.mark.parametrize("rms_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rmsprop", [True, False])
def test_dense_sweep_keeps_the_bits_without_a_gradient(rms_dtype, rmsprop):
    """Padding channels, masked cells, the sentinel row and live elements
    whose gradient is exactly 0 keep their master and rms bits; every
    other element moves; the stamps and the bf16 cells follow."""
    nb, B = 6, 4
    packed, rms, gd, gsh, mask, flag, last = ins = sweep_inputs(nb, B, rms_dtype)
    new, rms_new, cells, last_new = dsw.dense_sweep(*ins, rmsprop=rmsprop, **SWEEP_NUMBERS)
    grad = torch.zeros(packed.shape)
    grad[:nb, :, 0] = gd
    grad[:nb, :, 1:1 + 3 * B] = gsh
    grad[:nb] *= mask[..., None]
    zero = grad == 0
    assert bool(zero[:, :, 1 + 3 * B:].all()) and bool(zero[nb].all()) and bool(zero[:nb][~mask].all())
    assert bool((~zero).any())
    same_bits(new[zero], packed[zero], "masters without a gradient")
    assert bool((new[~zero] != packed[~zero]).all())
    if rmsprop:
        same_bits(rms_new[zero], rms[zero], "rms without a gradient")
        assert bool((rms_new[~zero] != 0).all())
    else:
        assert rms_new is rms
    same_bits(cells, new.to(torch.bfloat16), "cells")
    same_bits(last_new, torch.where(flag == 1, 11, last).index_fill_(0, torch.tensor([nb]), -1), "last_step")


def no_build(monkeypatch):
    """Make any build or load of a kernel library fail the test."""
    from nerf_projects_tpu_torch.ops.kernels import _build

    def built(*a, **k):
        raise AssertionError("a kernel library was built")

    for mod, name in ((_build, "build"), (_build, "load"), (dsw, "_library")):
        monkeypatch.setattr(mod, name, built)


def test_dense_sweep_takes_the_plain_version_for_host_tensors(monkeypatch):
    no_build(monkeypatch)
    ins = sweep_inputs(nb=3, B=9, rms_dtype=torch.bfloat16, seed=8)
    launches = dsw.dense_sweep.launches
    for rmsprop in (True, False):
        got = dsw.dense_sweep(*ins, rmsprop=rmsprop, **SWEEP_NUMBERS)
        want = dsw.dense_sweep_reference(*ins, rmsprop=rmsprop, **SWEEP_NUMBERS)
        for a, b in zip(got, want):
            same_bits(a, b)
    got = dsw.dense_sweep(*ins, rmsprop=True, cells=False, **SWEEP_NUMBERS)
    assert got[2] is None and dsw.dense_sweep.launches == launches


BAD_SWEEP_INPUTS = {
    "packed float64": (0, lambda x: x.double(), TypeError, "packed"),
    "packed not contiguous": (0, lambda x: x.transpose(0, 1).contiguous().transpose(0, 1), ValueError, "packed"),
    "rms float16": (1, lambda x: x.half(), TypeError, "rms"),
    "rms of another shape": (1, lambda x: x[:-1], ValueError, "rms"),
    "grad_density with the sentinel row": (2, lambda x: torch.cat([x, x[:1]]), ValueError, "grad_density"),
    "grad_sh not contiguous": (3, lambda x: x.transpose(0, 1).contiguous().transpose(0, 1), ValueError, "grad_sh"),
    "grad_sh of another basis": (3, lambda x: x[..., :3], ValueError, "grad_sh"),
    "cell_mask as floats": (4, lambda x: x.float(), TypeError, "cell_mask"),
    "flag int64": (5, lambda x: x.long(), TypeError, "flag"),
    "last_step without the sentinel": (6, lambda x: x[:-1], ValueError, "last_step"),
    "a device other than the CPU or a card": (None, lambda x: x.to("meta"), ValueError, "CUDA device or the CPU"),
}


@pytest.mark.parametrize("case", list(BAD_SWEEP_INPUTS))
def test_dense_sweep_raises_on_bad_inputs_before_any_build(case, monkeypatch):
    no_build(monkeypatch)
    which, bad, err, match = BAD_SWEEP_INPUTS[case]
    ins = sweep_inputs(nb=4, B=9)
    ins = [bad(x) if which in (None, i) else x for i, x in enumerate(ins)]
    with pytest.raises(err, match=match):
        dsw.dense_sweep(*ins, rmsprop=True, **SWEEP_NUMBERS)


def test_dense_optim_rejects_literal_rmsprop():
    trainer = make_trainer(rms_pervisit=False)
    bg = port_bg(16, seed=25)
    rays, target = batch(5, n_tiles=1)
    with pytest.raises(ValueError, match="dense_optim"):
        ps.train_step_tiles_packed_touched(trainer, bg, ps.packed_state_from_grid(bg), rays, target, 0, gen(0),
                                           dense_optim=True)


def test_states_round_trip_bit_for_bit():
    bg = port_bg(16, seed=3)
    for st, back in ((ps.sparse_state_from_grid(bg), ps.grid_from_sparse_state),
                     (ps.packed_state_from_grid(bg), ps.grid_from_packed_state)):
        padded = (ps.pad_state_rows(st, 16) if isinstance(st, ps.SparseBrickState)
                  else ps.pad_packed_state_rows(st, 16))
        assert all(x is None or x.shape[0] % 16 == 0 for x in padded)
        for s in (st, padded):
            out = back(bg, s)
            assert torch.equal(out.density_bricks, bg.density_bricks) and torch.equal(out.sh_bricks, bg.sh_bricks)
        assert int(padded.last_step[-1]) == -1


# ---------------------------------------------------------------------------
# K4's flags and host copies
# ---------------------------------------------------------------------------

def test_k4_flags_plain_version():
    """The plain backward's flags: the bricks of the runs that
    backward_flushes counts as adds (touched_bricks), every brick with a
    nonzero gradient among them, the sentinel 0; fused_grad_blocks returns
    them."""
    bg = port_bg(24, seed=60)
    rays, target = batch(61)
    opts = tgrid.GridRenderOptions(step_size=0.5)
    cells, pack, basis, max_steps = ttm.march_inputs(bg, rays, opts)
    kw = dict(max_steps=max_steps, color_mode=opts.color_mode, sigma_thresh=opts.sigma_thresh,
              stop_thresh=opts.stop_thresh)
    out = ttm.march_reference(cells, bg.brick_links, bg.reso, pack, basis, **kw)
    _, g, s_total = ttm.loss_seeds(out, target, opts, 1e-3)
    for spars in (0.0, 1e-3):
        gd, gsh, flags = ttm.march_backward(cells, bg.brick_links, bg.reso, pack, basis, g, s_total,
                                            sparsity_scale=spars, flag_touched=True, **kw)
        assert flags.dtype == torch.int32 and flags.shape == (bg.n_bricks + 1,) and int(flags[-1]) == 0
        want = ttm.touched_bricks(cells, bg.brick_links, bg.reso, pack, basis, g, s_total, sparsity_scale=spars,
                                  **kw)
        assert torch.equal(flags, want)
        nonzero = (gd != 0).any(1) | (gsh != 0).any(2).any(1)
        assert bool(flags[:-1][nonzero].all()) and 0 < int(flags.sum()) < bg.n_bricks
    _, grads, touched, aux = ttm.fused_grad_blocks(bg, rays, target, opts, beta_loss=1e-3, sparsity_loss=1e-3)
    assert torch.equal(touched, flags) and torch.equal(grads[0], gd)
    assert float(aux["window_miss"]) == 0.0 and int(aux["dropped_active_chunks"]) == 0


def test_a_touched_step_copies_no_host_numbers_to_its_device(monkeypatch):
    """After a first step, neither the touched nor the sparse step builds
    a tensor from host numbers or writes one into a tensor (on the card
    each such copy waits for the queue to drain)."""
    trainer = make_trainer()
    bg = port_bg(16, seed=18)
    rays, target = batch(19)
    st = ps.packed_state_from_grid(bg, bf16_cells=True)
    sst = ps.sparse_state_from_grid(bg)
    st, _ = ps.train_step_tiles_packed_touched(trainer, bg, st, rays, target, 0, gen(2), max_touched=32)
    sst, _ = ps.train_step_tiles_sparse(trainer, bg, sst, rays, target, 0, gen(2), max_touched=32)
    copies = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            copies.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch, name, counted)
    real_setitem = torch.Tensor.__setitem__

    def setitem(self, index, value):  # x[i] = 0.0 copies the host number to the device
        if not isinstance(value, torch.Tensor):
            copies.append(f"__setitem__ {value!r}")
        return real_setitem(self, index, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", setitem)
    st, a = ps.train_step_tiles_packed_touched(trainer, bg, st, rays, target, 1, gen(2), max_touched=32)
    sst, b = ps.train_step_tiles_sparse(trainer, bg, sst, rays, target, 1, gen(2), max_touched=32)
    monkeypatch.undo()
    assert copies == [] and bool(torch.isfinite(a["mse"])) and bool(torch.isfinite(b["mse"]))


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

JAX_STEPS = 2


def jax_trainer(**kw):
    return jpt.PlenoxelsTrainer(jgrid.GridRenderOptions(step_size=0.5), **{**TRAINER_KW, **kw})


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's touched step (lazy; per-visit with the dense sweep) and its
    sparse step, JAX_STEPS steps each from one 16^3 grid (2^3 bricks: one
    window holds the grid, so its march misses nothing) on 2 tiles of 128
    rays, K3 and K4 in interpret mode. The two touched runs share their
    first step's march (a memo of fused_grad_blocks)."""
    jg, tg = random_grids(16, 9, seed=70)
    jb, tb = jbg.from_sparse_grid(jg), tbg.from_sparse_grid(tg)
    batches = [both(tile_rays(2, 8, 16, seed=71 + i)) for i in range(JAX_STEPS)]
    real, memo = jps.fused_grad_blocks, {}

    def cached(bg, rays, gt, opts, **kw):
        ka = kw.get("kernel_arrays")
        parts = ka if isinstance(ka, (tuple, list)) else (ka,)
        key = hashlib.sha1(b"".join(np.asarray(x).tobytes() for x in parts + (rays.origins, rays.directions, gt))
                           ).hexdigest() + repr(sorted((k, v) for k, v in kw.items() if k != "kernel_arrays"))
        if key not in memo:
            memo[key] = real(bg, rays, gt, opts, **kw)
        return memo[key]

    old, jtm.INTERPRET, jps.fused_grad_blocks = jtm.INTERPRET, True, cached
    runs = {}
    try:
        for name, kw, make, step_fn, extra in (
                ("lazy", {}, jps.packed_state_from_grid, jps.train_step_tiles_packed_touched, {"max_touched": 64}),
                ("pervisit-dense", {"rms_pervisit": True}, jps.packed_state_from_grid,
                 jps.train_step_tiles_packed_touched, {"max_touched": 64, "dense_optim": True}),
                ("sparse", {}, jps.sparse_state_from_grid, jps.train_step_tiles_sparse, {})):
            trainer, st, mses, tv = jax_trainer(**kw), make(jb), [], []
            for i, (jr, _) in enumerate(batches):
                key = jax.random.PRNGKey(i)
                nb = jb.n_bricks
                ks = jax.random.split(key)
                tv.append([np.array(jtv.sample_brick_window(k, nb, max(int(f * nb), 1)))
                           for k, f in zip(ks, (trainer.tv_sparsity, trainer.tv_sh_sparsity))])
                st, stats = step_fn(trainer, jb, st, jr, jnp.full(jr.origins.shape, 0.35), jnp.asarray(i, jnp.int32),
                                    key, **extra)
                mses.append(float(stats["mse"]))
            grid = (jps.grid_from_packed_state if name != "sparse" else jps.grid_from_sparse_state)(jb, st)
            if name == "sparse":
                rms = (np.asarray(st.rms_density)[:nb].reshape(nb, 512), np.asarray(st.rms_sh))
                rms = (rms[0], np.asarray(jtm.kernel_layout_to_sh(st.rms_sh[:nb], 9)))
            else:
                B = 9
                rms = (np.asarray(st.rms)[:nb, B].reshape(nb, 8, 64, 3)[..., 0].reshape(nb, 512),
                       np.asarray(jtm.kernel_layout_to_sh(st.rms[:nb, :B], B)))
            runs[name] = dict(mse=mses, tv=tv, density=np.asarray(grid.density_bricks),
                              sh=np.asarray(grid.sh_bricks), rms=rms, last_step=np.asarray(st.last_step))
    finally:
        jtm.INTERPRET, jps.fused_grad_blocks = old, real
    return dict(runs=runs, tb=tb, batches=[b[1] for b in batches])


@pytest.mark.parametrize("name", ["lazy", "pervisit-dense", "sparse"])
def test_steps_match_jax_from_the_same_state(jax_runs, name, monkeypatch):
    want = jax_runs["runs"][name]
    tb = jax_runs["tb"]
    nb = tb.n_bricks
    trainer = make_trainer(**({"rms_pervisit": True} if name == "pervisit-dense" else {}))
    drawn = iter(torch.from_numpy(r) for rows in want["tv"] for r in rows)
    monkeypatch.setattr(ps, "sample_brick_window", lambda g, n, w: next(drawn))
    if name == "sparse":
        st = ps.sparse_state_from_grid(tb)
    else:
        st = ps.packed_state_from_grid(tb)
    mses = []
    for i, tr in enumerate(jax_runs["batches"]):
        target = torch.full(tr.origins.shape, 0.35)
        if name == "sparse":
            st, stats = ps.train_step_tiles_sparse(trainer, tb, st, tr, target, i, gen(0))
        else:
            st, stats = ps.train_step_tiles_packed_touched(trainer, tb, st, tr, target, i, gen(0), max_touched=64,
                                                           dense_optim=name == "pervisit-dense")
        mses.append(float(stats["mse"]))
    np.testing.assert_allclose(mses, want["mse"], rtol=JAX_MSE_RTOL)
    if name == "sparse":
        grid, rms = ps.grid_from_sparse_state(tb, st), (st.rms_density[:nb], st.rms_sh[:nb])
    else:
        grid = ps.grid_from_packed_state(tb, st)
        rms = packed_parts(st, nb)[2:]
    mostly_equal(grid.density_bricks, want["density"], frac=JAX_FRAC)
    mostly_equal(grid.sh_bricks, want["sh"], frac=JAX_FRAC)
    last, want_last = np_(st.last_step), want["last_step"]
    # JAX stamps every brick of its march windows, the port the bricks its
    # K4 adds into: the same stamps but where a window brick got no
    # gradient (2 of the 8 bricks on the second step here)
    assert ((last == want_last) | (last < want_last)).all() and (last == want_last).mean() >= 0.75
    assert (last[:nb] == JAX_STEPS - 1).any() and last[nb] == want_last[nb] == -1
    lazy = name != "pervisit-dense"
    for got, w in zip(rms, want["rms"]):
        if lazy:  # the rms that the dense recursion holds after the last step, on both sides
            got = rms_now(got, last[:nb], JAX_STEPS - 1, trainer.rms_beta)
            w = rms_now(w, want_last[:nb], JAX_STEPS - 1, trainer.rms_beta)
        mostly_equal(got, w, frac=JAX_FRAC)
