"""The port's spans and counters (``obs/trace.py``) on the CPU: nothing is
recorded while recording is off; roots, nesting and self time; garbage
collections as ``py.gc`` spans; the device timings and counters reduced
to the host; the profiler's session turning recording on and off; and
the frame, the NeRF render and step and the Plenoxels touched step
giving the same bits with recording on and off, their spans named and
nested as the benchmark's readers select them."""
import gc

import numpy as np
import pytest
import torch

from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig
from nerf_projects_tpu_torch.obs import trace
from nerf_projects_tpu_torch.ops.brick_grid import BrickGrid
from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
from nerf_projects_tpu_torch.ops.kernels import tile_march as ttm
from nerf_projects_tpu_torch.ops.kernels.frame_march import render_frame_pallas
from nerf_projects_tpu_torch.train import NeRFTrainer, PlenoxelsTrainer
from nerf_projects_tpu_torch.train import plenoxels_sparse as ps

MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def no_recording():
    """Each test starts and ends with recording off."""
    trace.stop()
    yield
    trace.stop()


def recorded(fn):
    """fn() with recording on -> (its result, the Recording)."""
    trace.start()
    try:
        out = fn()
    finally:
        rec = trace.stop()
    return out, rec


def names(rec, idx):
    return [rec.spans[i][0] for i in idx]


def children(rec, i):
    return [s[0] for s in rec.spans if s[3] == i]


# -- the recorder ----------------------------------------------------------

def test_off_records_nothing_and_hands_out_the_shared_no_op():
    assert not trace.recording()
    assert trace.span("frame") is trace.OFF and trace.span("x", device=True) is trace.OFF
    with trace.span("frame"):
        trace.count("c", 3)
        trace.count_device("d", lambda: pytest.fail("called while off"))
    assert trace.stop() is None


def test_nesting_roots_and_self_time():
    def work():
        with trace.span("frame"):
            with trace.span("march.pack"):
                pass
            with trace.span("k3.launch"):
                with trace.span("inner"):
                    pass
        with trace.span("frame"):
            pass
        trace.count("n", 2)
        trace.count("n", 1.5)

    _, rec = recorded(work)
    assert names(rec, rec.roots()) == ["frame", "frame"]
    r0, r1 = rec.roots()
    assert children(rec, r0) == ["march.pack", "k3.launch"]
    assert all(s[4] == r0 for s in rec.spans[r0:r1]) and rec.spans[r1][4] == r1
    inner = rec.select("inner", under="frame")
    assert len(inner) == 1 and rec.spans[rec.spans[inner[0]][3]][0] == "k3.launch"
    assert rec.counters["n"] == 3.5 and rec.device_ms == {}

    # self time: the duration less the union of the children's intervals
    syn = trace.Recording(spans=[
        ("frame", 0, 10 * MS, -1, 0),
        ("a", 1 * MS, 4 * MS, 0, 0),
        ("b", 3 * MS, 6 * MS, 0, 0),      # overlaps a: the union is 1..6
        ("py.gc", 8 * MS, 9 * MS, 0, 0),
        ("c", 4 * MS, 5 * MS, 2, 0),      # b's child, not frame's
        ("frame", 20 * MS, 22 * MS, -1, 5),
        ("a", 20 * MS, 21 * MS, 5, 5),
    ], device_ms={1: 0.5, 6: 0.25})
    assert syn.self_ns(0) == 4 * MS and syn.self_ns(2) == 2 * MS and syn.self_ns(4) == 1 * MS
    assert syn.host_ms("a", under="frame") == pytest.approx(4.0)
    assert syn.host_ms("frame", self_time=True) == pytest.approx(4.0 + 1.0)
    assert syn.device_total_ms("a", under="frame") == pytest.approx(0.75)
    assert syn.select("a", under="view") == []
    s = syn.summary()
    assert s["frame"]["count"] == 2 and s["a"]["device_ms"] == pytest.approx(0.75)
    assert list(s) == ["frame", "a", "b", "py.gc", "c"]
    assert "py.gc" in syn.table()


def test_a_collection_inside_a_span_is_a_py_gc_child():
    def work():
        with trace.span("frame"):
            gc.collect()

    _, rec = recorded(work)
    root = rec.roots("frame")[0]
    gcs = rec.select("py.gc", under="frame")
    assert gcs and all(rec.spans[i][3] == root for i in gcs)
    duration = lambda i: rec.spans[i][2] - rec.spans[i][1]  # noqa: E731
    assert rec.self_ns(root) <= duration(root) - duration(gcs[0])
    assert rec.roots() == [root]  # py.gc is never a root


def test_device_spans_and_device_counters_on_host_tensors():
    x = torch.arange(5.0)

    def work():
        with trace.span("view"):
            with trace.span("nerf.mlp", device=True):
                y = x * 2
            trace.count_device("rows", (y > 2).sum())
            trace.count_device("rows", lambda: (y > 6).sum())
        return y

    _, rec = recorded(work)
    assert rec.device_ms == {} and rec.counters["rows"] == 3 + 1
    assert "alloc.device_mallocs" not in rec.counters and not rec.watched_syncs


def test_the_recorder_follows_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with trace.span("frame"):
        pass
    assert not trace.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("frame"):
            with trace.span("frame.outputs"):
                pass
        assert trace.recording()
    rec = trace.stop()
    assert names(rec, range(len(rec.spans))) == ["frame", "frame.outputs"]
    # a recording nobody stopped ends at the first root span after the
    # profiler stopped, and that span records nothing
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("frame"):
            pass
    assert trace.recording()
    assert trace.span("frame") is trace.OFF and not trace.recording() and trace.stop() is None
    # explicitly started inside a session, it outlives the session
    with profile(activities=[ProfilerActivity.CPU]):
        trace.start()
    with trace.span("frame"):
        pass
    assert trace.recording() and len(trace.stop().roots("frame")) == 1


# -- the program's spans ---------------------------------------------------

def small_grid(reso=16, B=4, seed=0):
    """Every brick of a reso^3 grid active, random densities and SH."""
    n = reso // 8
    g = torch.Generator().manual_seed(seed)
    coords = torch.stack(torch.meshgrid(*(torch.arange(n, dtype=torch.int32),) * 3, indexing="ij"), -1)
    return BrickGrid(
        brick_links=torch.arange(n**3, dtype=torch.int32).reshape(n, n, n),
        density_bricks=torch.rand((n**3, 512), generator=g) * 4.0,
        sh_bricks=torch.randn((n**3, 512, 3 * B), generator=g) * 0.3,
        cell_mask=torch.ones((n**3, 512), dtype=torch.bool), brick_coords=coords.reshape(-1, 3),
        reso=(reso,) * 3, radius=np.ones(3, np.float32), center=np.zeros(3, np.float32), basis_dim=B)


def tile_rays(n_tiles=4, r=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    uv = (torch.rand((n_tiles, r, 2), generator=g) - 0.5) * 0.6
    d = torch.cat([uv, torch.ones((n_tiles, r, 1))], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.tensor([0.0, 0.0, -2.5]).expand(n_tiles, r, 3).contiguous()
    return Rays(o, d, d)


def test_the_frame_gives_the_same_bits_and_its_spans():
    bg, rays = small_grid(), tile_rays()
    opts = GridRenderOptions(step_size=0.5)
    ka = ttm.build_kernel_arrays(bg)

    def frame():
        return render_frame_pallas(ttm.geometry_only(bg), rays, opts, kernel_arrays=ka, use_occupancy=False,
                                   return_depth=True)

    off = frame()
    on, rec = recorded(frame)
    assert list(off) == list(on) == ["rgb", "acc", "log_transmit", "depth"]
    for k in off:
        assert torch.equal(off[k], on[k]), k
    assert float(off["acc"].max()) > 0.5
    (root,) = rec.roots()
    assert rec.spans[root][0] == "frame"
    # k3.launch wraps the card's launch; the host runs the plain march
    assert children(rec, root) == ["march.pack", "frame.outputs"]
    tiles = ttm.render_tiles_pallas(bg, rays, opts, return_depth=True, early_stop=True)
    assert {"window_miss", "miss_per_ray", "sparsity_sum", "dropped_active_chunks"} <= set(tiles)
    for k in off:
        assert torch.equal(off[k], tiles[k]), k


def nerf_trainer(**kw):
    cfg = NeRFRenderConfig(num_coarse_samples=8, num_fine_samples=8, perturb=False, white_bkgd=True)
    return NeRFTrainer(cfg, device="cpu", **kw)


def nerf_rays(n=24, seed=2):
    g = torch.Generator().manual_seed(seed)
    d = torch.randn((n, 3), generator=g) * 0.1 + torch.tensor([0.0, 0.0, -1.0])
    o = torch.tensor([0.0, 0.0, 4.0]).expand(n, 3).contiguous()
    return Rays(o, d, d / torch.linalg.norm(d, dim=-1, keepdim=True))


def test_a_nerf_view_gives_the_same_bits_and_its_spans():
    tr = nerf_trainer(use_fused_mlp=True)
    assert tr.use_fused_mlp
    params = tr.init_params(0)
    rays = nerf_rays()

    def view():
        return tr.render_image(params, rays, chunk=16, use_kernel=True)

    off = view()
    on, rec = recorded(view)
    for k in off:
        assert torch.equal(off[k], on[k]), k
    (root,) = rec.roots()
    assert rec.spans[root][0] == "view"
    # per chunk and level: the samples, the encodings (posenc, then the
    # kernel's padding), the MLP and the compositing
    level = ["nerf.sample", "nerf.encode", "nerf.encode", "nerf.mlp", "nerf.composite"]
    assert children(rec, root) == level * 4
    assert set(rec.summary()) == set(level) | {"view"}


def test_a_nerf_step_is_a_root():
    tr = nerf_trainer(depth=2, width=32)
    state = tr.init_state(0)
    rays = nerf_rays(8)
    _, rec = recorded(lambda: tr.train_step(state, rays, torch.full((8, 3), 0.5)))
    (root,) = rec.roots()
    assert rec.spans[root][0] == "nerf.step"
    assert {"nerf.sample", "nerf.encode", "nerf.composite"} <= set(names(rec, range(len(rec.spans))))


def test_the_touched_step_gives_the_same_bits_and_its_spans_and_counters():
    bg = small_grid(B=9)
    trainer = PlenoxelsTrainer(GridRenderOptions(step_size=0.5), n_iters=1000, lr_sigma=30.0, lr_sh=1e-2,
                               lambda_tv=0.0, lambda_tv_sh=0.0, rms_pervisit=True, device="cpu")
    rays = tile_rays(2, 128, seed=3)
    target = torch.full(rays.origins.shape, 0.35)

    def step():
        st = ps.packed_state_from_grid(bg, bf16_cells=True)
        return ps.train_step_tiles_packed_touched(trainer, ttm.geometry_only(bg), st, rays, target, 5,
                                                  torch.Generator().manual_seed(4), max_touched=64,
                                                  dense_optim=True)

    (st_off, stats_off) = step()
    (st_on, stats_on), rec = recorded(step)
    for a, b in zip(st_off, st_on):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(stats_off["mse"], stats_on["mse"])
    (root,) = rec.roots()
    assert rec.spans[root][0] == "plenoxels.step"
    assert children(rec, root) == ["plenoxels.march", "plenoxels.accumulate", "plenoxels.sweep"]
    march = rec.select("plenoxels.march")[0]
    assert children(rec, march) == ["march.pack"]
    assert rec.select("march.pack", under="frame") == []
    assert rec.counters["plenoxels.rows_swept"] == bg.n_bricks + 1
    st = ps.packed_state_from_grid(bg, bf16_cells=True)
    _, deferred = ps.train_step_tiles_packed_touched(trainer, ttm.geometry_only(bg), st, rays, target, 5,
                                                     torch.Generator().manual_seed(4), max_touched=64,
                                                     dense_optim="defer")
    flagged = rec.counters["plenoxels.rows_flagged"]
    assert 0 < flagged == int(deferred["touched_flag"].sum()) <= bg.n_bricks + 1
