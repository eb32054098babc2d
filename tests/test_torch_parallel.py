"""The port's chunking, device mesh, sharded rendering and process gates
(``core/chunk.py``, ``parallel/mesh.py``, ``parallel/render.py``) against
the JAX package's, which run on the 8-device CPU mesh of conftest.py.

The mesh checks need two processes: they run once for the whole file, on
two host ranks over gloo in fresh processes (``parallel/launch.py``), and
every test reads their results through the module fixture ``ranks``. The
ranks import this module, so it imports JAX only inside the functions
that run in the test's own process. Tolerances: the chunked and sharded
results equal the unsharded ones bit for bit (the same ops on the same
rows); against JAX, 1e-6 on tanh and 1e-5 on a grid render
(tests/test_parallel.py's).
"""
import numpy as np
import pytest
import torch

from nerf_projects_tpu_torch.core import chunk_apply, pad_to_multiple
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.parallel.launch import start_ranks

W = 2
N_RENDER = 100   # not a multiple of 2 (nor of the chunk)


def unit_dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def grid_rays(n=64, seed=1):
    """tests/test_parallel.py's grid rays: from -3 d towards the centre."""
    d = unit_dirs(n, seed)
    return -3.0 * d, d


def port_grid():
    from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid

    return SparseGrid.create(16, basis_dim=1, init_density=3.0, device="cpu")


def render_grid(grid, rays):
    from nerf_projects_tpu_torch.ops.grid import GridRenderOptions, volume_render_grid

    return volume_render_grid(grid, rays, GridRenderOptions())


# ---------------------------------------------------------------------------
# What each rank runs (in its own process: no JAX here)
# ---------------------------------------------------------------------------

def rank_main():
    from nerf_projects_tpu_torch.parallel import RAY_AXIS, make_mesh, replicate, shard_rays
    from nerf_projects_tpu_torch.parallel import render as pr

    out = {}
    mesh = make_mesh(device="cpu")
    mesh2 = make_mesh(2, axes={"rays": 2, "grid": 1}, device="cpu")
    out["mesh"] = dict(names=mesh.mesh_dim_names, shape=tuple(mesh.mesh.shape), names2=mesh2.mesh_dim_names,
                       shape2=tuple(mesh2.mesh.shape))
    bad = []
    for n, axes in ((2, {"rays": 3}), (4, {"rays": 2, "grid": 2})):
        try:
            make_mesh(n, axes=axes, device="cpu")
            bad.append(False)
        except ValueError:
            bad.append(True)
    out["bad_axes_raise"] = bad
    try:
        shard_rays(mesh, torch.zeros(5, 3))
        out["odd_batch_raises"] = False
    except ValueError:
        out["odd_batch_raises"] = True
    x = torch.arange(64 * 3, dtype=torch.float32).reshape(64, 3)
    out["shard"] = shard_rays(mesh, x)
    out["shard2"] = shard_rays(mesh2, x)
    out["replicated"] = replicate(mesh, torch.full((3,), float(pr.process_index())))

    d = torch.from_numpy(unit_dirs(N_RENDER, 0))
    rays = Rays(torch.zeros_like(d), d, d)
    out["tanh"] = pr.render_rays_sharded(mesh, lambda r: {"rgb": torch.tanh(r.directions * 2.0)}, rays)
    out["tanh_chunked"] = pr.render_rays_sharded(mesh2, lambda r: {"rgb": torch.tanh(r.directions * 2.0)}, rays,
                                                 chunk=16)
    o, gd = (torch.from_numpy(a) for a in grid_rays())
    grid = port_grid()
    out["grid"] = pr.render_rays_sharded(mesh, lambda r: render_grid(grid, r), Rays(o, gd, gd))
    img = torch.from_numpy(unit_dirs(12 * 12, 2).reshape(12, 12, 3))
    out["image"] = pr.render_image_sharded(mesh, lambda r: {"rgb": r.directions * 0.5},
                                           Rays(torch.zeros_like(img), img, img))
    out["gates"] = dict(index=pr.process_index(), count=pr.process_count(), main=pr.is_main_process(),
                        shard=pr.host_shard_slice(8), shard_odd=pr.host_shard_slice(9), axis=RAY_AXIS)
    out["draw"] = torch.rand(8, generator=pr.host_offset_generator(0, "cpu"))
    return out


# ---------------------------------------------------------------------------
# The test's process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def launched():
    """The two ranks, started before the file's first test: they run
    while the tests that need no ranks do."""
    return start_ranks("tests.test_torch_parallel:rank_main", W)


@pytest.fixture(scope="module")
def ranks(launched):
    return launched.join()


def test_pad_to_multiple_matches_jax():
    from nerf_projects_tpu.core.chunk import pad_to_multiple as jpad

    x = np.random.default_rng(0).standard_normal((10, 3, 2)).astype(np.float32)
    for multiple, axis in ((4, 0), (5, 0), (4, 1), (3, 2)):
        want, wn = jpad(x, multiple, axis=axis)
        got, gn = pad_to_multiple(torch.from_numpy(x), multiple, axis=axis)
        assert gn == wn
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunk_apply_matches_jax():
    """A dict of a tensor and a Rays through 7-row chunks (37 rows: a
    padded tail) against JAX's lax.map version, and against fn on the
    whole batch."""
    import jax.numpy as jnp

    from nerf_projects_tpu.core.chunk import chunk_apply as jchunk
    from nerf_projects_tpu.core.rays import Rays as JaxRays

    rng = np.random.default_rng(1)
    a, o, d = (rng.standard_normal((37, 3)).astype(np.float32) for _ in range(3))

    def fn_j(t):
        return {"s": jnp.sin(t["a"]) + t["r"].origins, "n": jnp.sum(t["r"].directions, -1)}

    def fn_t(t):
        return {"s": torch.sin(t["a"]) + t["r"].origins, "n": torch.sum(t["r"].directions, -1)}

    want = jchunk(fn_j, {"a": jnp.asarray(a), "r": JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d))}, 7)
    tree = {"a": torch.from_numpy(a), "r": Rays(*(torch.from_numpy(v) for v in (o, d, d)))}
    got = chunk_apply(fn_t, tree, 7)
    whole = fn_t(tree)
    for k in want:
        assert got[k].shape == whole[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
        assert torch.equal(got[k], whole[k])


def test_make_mesh_on_two_ranks(ranks):
    """1-D and 2-D meshes over two ranks; axes that do not multiply to the
    device count raise, and so does a batch W does not divide."""
    for r in ranks:
        m = r["mesh"]
        assert m["names"] == ("rays",) and m["shape"] == (2,)
        assert m["names2"] == ("rays", "grid") and m["shape2"] == (2, 1)
        assert r["bad_axes_raise"] == [True, True]
        assert r["odd_batch_raises"]


def test_shard_rays_matches_jax_addressable_shards(ranks):
    """Rank r's rows are the rows JAX's NamedSharding(mesh, P("rays"))
    puts on device r of a two-device mesh, on the 1-D and the 2-D mesh."""
    import jax.numpy as jnp

    from nerf_projects_tpu.parallel.mesh import make_mesh as jmesh
    from nerf_projects_tpu.parallel.mesh import shard_rays as jshard

    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    for key, mesh in (("shard", jmesh(2)), ("shard2", jmesh(2, axes={"rays": 2, "grid": 1}))):
        placed = jshard(mesh, jnp.asarray(x))
        by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
        for r, dev in enumerate(mesh.devices.reshape(2, -1)[:, 0]):
            np.testing.assert_array_equal(ranks[r][key].numpy(), by_device[dev])


def test_replicate_broadcasts_rank_0(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["replicated"].numpy(), np.zeros(3, np.float32))


def test_render_rays_sharded_matches_jax(ranks):
    """100 rays (padded to whole shards and cropped) through a tanh and
    through volume_render_grid of SparseGrid.create(16), on both ranks,
    against JAX's render_rays_sharded on its two-device mesh and the
    unsharded render."""
    import jax.numpy as jnp

    from nerf_projects_tpu.core.rays import Rays as JaxRays
    from nerf_projects_tpu.models.sparse_grid import SparseGrid as JaxGrid
    from nerf_projects_tpu.ops.grid import GridRenderOptions as JaxOpts
    from nerf_projects_tpu.ops.grid import volume_render_grid as jrender
    from nerf_projects_tpu.parallel.mesh import make_mesh as jmesh
    from nerf_projects_tpu.parallel.render import render_rays_sharded as jsharded

    mesh = jmesh(2)
    d = unit_dirs(N_RENDER, 0)
    want_tanh = jsharded(mesh, lambda r: {"rgb": jnp.tanh(r.directions * 2.0)},
                         JaxRays(jnp.zeros_like(jnp.asarray(d)), jnp.asarray(d), jnp.asarray(d)))["rgb"]
    o, gd = grid_rays()
    jg = JaxGrid.create(16, basis_dim=1, init_density=3.0)
    jr = JaxRays(jnp.asarray(o), jnp.asarray(gd), jnp.asarray(gd))
    want_grid = jsharded(mesh, lambda r: jrender(jg, r, JaxOpts()), jr)["rgb"]
    whole = render_grid(port_grid(), Rays(*(torch.from_numpy(a) for a in (o, gd, gd))))["rgb"].numpy()
    for r in ranks:
        for key in ("tanh", "tanh_chunked"):
            assert r[key]["rgb"].shape == (N_RENDER, 3) and isinstance(r[key]["rgb"], np.ndarray)
            np.testing.assert_allclose(r[key]["rgb"], np.asarray(want_tanh), atol=1e-6)
            np.testing.assert_array_equal(r[key]["rgb"], torch.tanh(torch.from_numpy(d) * 2.0).numpy())
        np.testing.assert_allclose(r["grid"]["rgb"], np.asarray(want_grid), atol=1e-5)
        np.testing.assert_array_equal(r["grid"]["rgb"], whole)


def test_render_image_sharded(ranks):
    img = unit_dirs(12 * 12, 2).reshape(12, 12, 3)
    for r in ranks:
        assert r["image"]["rgb"].shape == (12, 12, 3)
        np.testing.assert_array_equal(r["image"]["rgb"], img * np.float32(0.5))


def test_process_gates_on_two_ranks(ranks):
    """tests/test_multiprocess.py's checks, with a rank for a host:
    complementary shards of 8 (the last takes the remainder of 9), rank 0
    alone is the main process, and the offset generators draw differently."""
    g0, g1 = (r["gates"] for r in ranks)
    assert (g0["index"], g1["index"]) == (0, 1) and g0["count"] == g1["count"] == 2
    assert g0["main"] and not g1["main"]
    assert (g0["shard"], g1["shard"]) == (slice(0, 4), slice(4, 8))
    assert (g0["shard_odd"], g1["shard_odd"]) == (slice(0, 4), slice(4, 9))
    assert not torch.equal(ranks[0]["draw"], ranks[1]["draw"])


def test_process_gates_in_one_process():
    """Without a process group there is one process (JAX's
    TestHostHelpers)."""
    from nerf_projects_tpu_torch.parallel import render as pr

    assert pr.process_index() == 0 and pr.process_count() == 1 and pr.is_main_process()
    assert pr.host_shard_slice(100) == slice(0, 100)
    a = torch.rand(4, generator=pr.host_offset_generator(3, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=pr.host_offset_generator(3, "cpu")))


# ---------------------------------------------------------------------------
# Kernels launch on their tensors' card
# ---------------------------------------------------------------------------

def test_launch_stream_makes_the_tensors_device_current(monkeypatch):
    """``launch_stream`` enters ``torch.cuda.device(dev)`` and takes dev's
    current stream inside it (by monkeypatch: the host has no card)."""
    import contextlib

    from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

    events = []

    @contextlib.contextmanager
    def device(dev):
        events.append(("enter", str(dev)))
        yield
        events.append(("exit", str(dev)))

    class Stream:
        def __init__(self, dev):
            events.append(("stream", str(dev)))
            self.cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    with fm.launch_stream(torch.device("cuda", 1)) as stream:
        events.append(("launch", stream))
    assert events == [("enter", "cuda:1"), ("stream", "cuda:1"), ("launch", 1234), ("exit", "cuda:1")]


def test_every_launch_is_inside_launch_stream():
    """Every C launch of the kernel wrappers (a call handed the ``stream``)
    sits in a ``with launch_stream(dev) as stream`` block, and no wrapper
    takes a stream or sets a device any other way."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "nerf_projects_tpu_torch" / "ops" / "kernels"
    launches = 0
    for path in sorted(root.glob("*.py")):
        tree = ast.parse(path.read_text())
        inside = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    isinstance(i.context_expr, ast.Call) and getattr(i.context_expr.func, "attr",
                                                                     getattr(i.context_expr.func, "id", ""))
                    == "launch_stream" for i in node.items):
                inside.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and any(isinstance(a, ast.Name) and a.id == "stream" for a in node.args):
                assert id(node) in inside, f"{path.name}:{node.lineno} launches outside launch_stream"
                launches += 1
            if isinstance(node, ast.Attribute) and node.attr in ("current_stream", "device") and \
                    isinstance(node.value, ast.Attribute) and node.value.attr == "cuda":
                assert path.name == "fused_mlp.py", f"{path.name}:{node.lineno} sets a device or takes a stream"
    assert launches >= 8  # K1f / K1rf, K1b / K1rb, K2, K3 (and its probe), K4, K5f, K5b
