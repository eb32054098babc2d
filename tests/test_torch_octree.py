"""The port's PlenOctree (``models/octree.py``), its native host ops
(``utils/native.py``: the octree walk, the median cut) and its renderer
(``ops/octree_render.py``) on the CPU against the JAX package on the same
seeded numpy trees and rays.

Held bit for bit: the topology (``child``, ``leaf_cells``, ``refine``,
``leaf_order_lookup``), ``locate`` and ``query``, the octree walk against
the JAX package's Python walk (kept here as the reference version), the
median cut against the JAX package's native op (the same C++, whose box
choice the port makes through a heap), and the npz in both directions.
The render's rgb, acc and depth and its gradient in ``data`` are held
within 1e-5 (float32 on both sides; the port sums each slice of steps at
once, JAX one step at a time).
"""
import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dataclasses import replace

from nerf_projects_tpu.core.rays import Rays as JRays
from nerf_projects_tpu.models.octree import PlenOctree as JTree
from nerf_projects_tpu.ops import octree_render as jor
from nerf_projects_tpu.utils import native as jnative
from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.models.octree import PlenOctree as TTree
from nerf_projects_tpu_torch.ops import octree_render as tor
from nerf_projects_tpu_torch.ops.kernels import _build
from nerf_projects_tpu_torch.utils import native

TOL = 1e-5
CENTER, RADIUS = (0.1, -0.2, 0.05), (1.2, 1.0, 1.1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tree_pair(seed, data_dim=13, rounds=3, share=0.35, sigma_hi=30.0, quiet_rim=False):
    """The same random tree in both packages: ``rounds`` refines of a
    random share of the leaves, then random data (sigma U[-2, sigma_hi],
    a quarter of the cells empty). ``quiet_rim``: no density in the leaves
    on the cube's faces. A ray's first sample lies on the face it enters
    by, where one rounding decides whether it is inside, and JAX's jitted
    march rounds its positions otherwise (XLA fuses multiply-adds)."""
    rng = np.random.default_rng(seed)
    jt = JTree.create(data_dim, center=CENTER, radius=RADIUS, depth_limit=rounds + 2)
    tt = TTree.create(data_dim, center=CENTER, radius=RADIUS, depth_limit=rounds + 2, device="cpu")
    for _ in range(rounds):
        mask = rng.uniform(size=jt.n_leaves) < share
        jt, tt = jt.refine(mask), tt.refine(mask)
    data = rng.standard_normal(np.asarray(jt.data).shape).astype(np.float32) * 0.7
    data[..., -1] = rng.uniform(-2.0, sigma_hi, data.shape[:-1]) * (rng.uniform(size=data.shape[:-1]) > 0.25)
    if quiet_rim:
        cells, _, corner, size = jt.leaf_depths_and_corners()
        rim = ((corner == 0.0) | (corner + size[:, None] == 1.0)).any(-1)
        c = cells[rim]
        data[c[:, 0], c[:, 1], c[:, 2], c[:, 3], -1] = 0.0
    return replace(jt, data=jnp.asarray(data)), tt.replace(data=torch.from_numpy(data))


def ray_arrays(seed, n=48, radius=3.0):
    rng = np.random.default_rng(seed)
    look = rng.standard_normal((n, 3))
    origins = radius * look / np.linalg.norm(look, axis=-1, keepdims=True)
    dirs = (np.asarray(CENTER) - origins) / radius + 0.25 * rng.standard_normal((n, 3))
    dirs *= rng.uniform(0.5, 2.0, (n, 1))  # not unit: the march's world length
    viewdirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (origins, dirs, viewdirs)]


def both_rays(arrays):
    return JRays(*(jnp.asarray(a) for a in arrays)), Rays(*(torch.from_numpy(a) for a in arrays))


# ---------------------------------------------------------------------------
# topology and queries
# ---------------------------------------------------------------------------

def test_create_and_refine_match_jax():
    """The same masks give the same child bits, leaf order and lookup;
    refine copies a cell's data into its eight children, as JAX's does."""
    jt, tt = tree_pair(0)
    np.testing.assert_array_equal(tt.child_host, np.asarray(jt.child))
    np.testing.assert_array_equal(tt.child.numpy(), np.asarray(jt.child))
    assert tt.n_nodes == jt.n_nodes and tt.n_leaves == jt.n_leaves and tt.data_dim == 13
    np.testing.assert_array_equal(tt.leaf_cells(), jt.leaf_cells())
    np.testing.assert_array_equal(tt.leaf_order_lookup(), jt.leaf_order_lookup())
    mask = np.random.default_rng(1).uniform(size=jt.n_leaves) < 0.5
    j2, t2 = jt.refine(mask), tt.refine(mask)
    np.testing.assert_array_equal(t2.child_host, np.asarray(j2.child))
    np.testing.assert_array_equal(t2.data.numpy(), np.asarray(j2.data))
    j3, t3 = JTree.create(4).refine(), TTree.create(4, device="cpu").refine()
    assert t3.n_nodes == j3.n_nodes == 9 and t3.n_leaves == j3.n_leaves == 64
    assert tt.refine(np.zeros(tt.n_leaves, bool)) is tt


def test_locate_and_query_match_jax():
    """Random world points (a third outside the cube) and points on the
    finest cells' faces, edges and corners: the same leaf, cell and
    inside bits; the same query rows, zeros outside. Against JAX's eager
    calls: jitted, XLA on the CPU fuses some lanes' p * invradius + offset
    into one rounding (an FMA) and not others, which moves points on a
    face to the other side of it."""
    jt, tt = tree_pair(2)
    rng = np.random.default_rng(3)
    pts = (np.asarray(CENTER) + rng.uniform(-1.5, 1.5, (4000, 3)) * np.asarray(RADIUS)).astype(np.float32)
    grid = np.stack(np.meshgrid(*[np.arange(17) / 16.0] * 3, indexing="ij"), -1).reshape(-1, 3)
    faces = ((grid - jt.offset) / jt.invradius).astype(np.float32)
    p = np.concatenate([pts, faces])
    want = jt.locate(jnp.asarray(p))
    got = tt.locate(torch.from_numpy(p))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    vals = np.asarray(jt.query(jnp.asarray(p)))
    np.testing.assert_array_equal(tt.query(torch.from_numpy(p)).numpy(), vals)
    np.testing.assert_array_equal(tt.query(torch.from_numpy(p), column=12).numpy(), vals[:, 12])
    assert 0 < int((~got[2][len(pts):]).sum()) < len(faces)  # the upper faces are outside


def python_leaf_walk(child):
    """The JAX package's Python walk of leaf_depths_and_corners (the
    reference version of the native op): per node its depth, corner and
    edge, then each leaf's."""
    n_nodes = child.shape[0]
    node_depth = np.zeros(n_nodes, np.int32)
    node_corner = np.zeros((n_nodes, 3), np.float64)
    node_size = np.ones(n_nodes, np.float64)
    for node in range(n_nodes):
        for i in range(2):
            for j in range(2):
                for k in range(2):
                    c = child[node, i, j, k]
                    if c != 0:
                        tgt = node + c
                        node_depth[tgt] = node_depth[node] + 1
                        half = node_size[node] * 0.5
                        node_corner[tgt] = node_corner[node] + np.array([i, j, k]) * half
                        node_size[tgt] = half
    n, i, j, k = np.nonzero(child == 0)
    half = node_size[n] * 0.5
    corner = node_corner[n] + np.stack([i, j, k], -1) * half[:, None]
    return np.stack([n, i, j, k], -1), node_depth[n] + 1, corner, half


@pytest.mark.parametrize("seed", [4, 5])
def test_leaf_geometry_native_equals_python_walk_and_jax(seed):
    jt, tt = tree_pair(seed, rounds=4, share=0.3)
    got = tt.leaf_depths_and_corners()
    for g, w in zip(got, python_leaf_walk(np.asarray(jt.child))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, jt.leaf_depths_and_corners()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tt._parent_depth_table(), jt._parent_depth_table())
    assert tt.max_depth() == int(got[1].max()) == 5 and TTree.create(4, device="cpu").max_depth() == 1


def python_median_cut(vectors, n_colors):
    """The JAX package's Python median cut (its fallback), the reference
    version of the native op's algorithm."""
    n = len(vectors)
    ids = np.zeros(n, np.int64)
    boxes = {0: np.arange(n)}
    next_id = 1
    while len(boxes) < n_colors:
        best, best_score = None, 0.0
        for b, idx in boxes.items():
            if len(idx) < 2:
                continue
            rng = vectors[idx].max(0) - vectors[idx].min(0)
            score = float(rng.max()) * len(idx)
            if score > best_score:
                best, best_score = b, score
        if best is None:
            break
        idx = boxes[best]
        axis = int(np.argmax(vectors[idx].max(0) - vectors[idx].min(0)))
        order = np.argsort(vectors[idx, axis], kind="stable")
        half = len(idx) // 2
        lo, hi = idx[order[:half]], idx[order[half:]]
        boxes[best] = lo
        boxes[next_id] = hi
        ids[hi] = next_id
        next_id += 1
    palette = np.zeros((next_id, vectors.shape[1]), np.float32)
    for b, idx in boxes.items():
        if len(idx):
            palette[b] = vectors[idx].mean(0)
    return palette.astype(np.float16), ids.astype(np.uint16 if next_id <= 65536 else np.uint32)


@pytest.mark.parametrize("n,n_colors,distinct", [(5000, 256, None), (3000, 4096, 40), (4000, 64, None)])
def test_median_cut_native_equals_jax_native(n, n_colors, distinct):
    """The port's op (boxes chosen from a heap) gives the JAX package's
    native op's palette and ids bit for bit: random colours, and 40
    distinct colours under a budget of 4,096 (ties everywhere, boxes that
    stop splitting)."""
    rng = np.random.default_rng(n)
    vec = rng.standard_normal((n, 3)).astype(np.float32)
    if distinct:
        vec = vec[rng.integers(0, distinct, n)]
    got = native.median_cut(vec, n_colors)
    want = jnative.median_cut(vec, n_colors)
    assert want is not None, "the JAX package's native op did not build"
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (distinct or n_colors) <= len(got[0]) <= n_colors


def test_median_cut_native_against_its_python_version():
    """Few distinct colours: each its own box in both, the palette exact;
    many: the same number of boxes and a quantization error within 10%
    of the Python version's (they split equal keys and average in other
    orders)."""
    rng = np.random.default_rng(6)
    few = rng.uniform(0, 1, (5, 3)).astype(np.float16).astype(np.float32)[rng.integers(0, 5, 500)]
    for g, w in zip(native.median_cut(few, 16), python_median_cut(few, 16)):
        np.testing.assert_array_equal(np.sort(g, axis=0), np.sort(w, axis=0))
    many = rng.standard_normal((3000, 3)).astype(np.float32)
    (pg, ig), (pw, iw) = native.median_cut(many, 128), python_median_cut(many, 128)
    assert len(pg) == len(pw) == 128
    err = [np.mean((p.astype(np.float32)[i.astype(np.int64)] - many) ** 2) for p, i in ((pg, ig), (pw, iw))]
    assert err[0] <= 1.1 * err[1], err


def test_native_ops_raise_on_a_failed_build(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses raises with g++'s output."""
    (tmp_path / "native_ops.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _build.load_host.cache_clear()
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.octree_leaf_geometry(np.zeros((1, 2, 2, 2), np.int32))
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.median_cut(np.zeros((4, 3), np.float32), 2)
    finally:
        monkeypatch.undo()
        _build.load_host.cache_clear()
        native._lib.cache_clear()
    assert isinstance(native._lib(), ctypes.CDLL)


def test_npz_loads_bit_for_bit_in_both_packages(tmp_path):
    jt, tt = tree_pair(7)
    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jt.save(jp)
    tt.save(tp)
    zj, zt = np.load(jp), np.load(tp)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zt[k], zj[k])
    for path in (jp, tp):
        j, t = JTree.load(path), TTree.load(path, device="cpu")
        np.testing.assert_array_equal(t.child_host, np.asarray(j.child))
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.invradius, j.invradius)
        np.testing.assert_array_equal(t.offset, j.offset)
        assert t.depth_limit == j.depth_limit and t.data.dtype == torch.float32


def test_the_tree_is_on_the_card_unless_asked():
    if torch.cuda.is_available():
        assert TTree.create(4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTree.create(4)


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("color_mode", ["sigmoid", "bias"])
@pytest.mark.parametrize("stop_thresh", [1e-2, 0.0], ids=["early stop", "no early stop"])
def test_volume_render_octree_matches_jax(color_mode, stop_thresh):
    """rgb, acc and depth at step 1e-2, and the gradient in ``data`` of a
    random weighting of rgb, acc and depth, within 1e-5 of scale; the
    march in slices of 16 steps (several slices a ray)."""
    jt, tt = tree_pair(8 + (color_mode == "bias"), quiet_rim=True)
    jr, tr = both_rays(ray_arrays(9))
    opts_j = jor.OctreeRenderOptions(step_size=1e-2, stop_thresh=stop_thresh, color_mode=color_mode)
    opts_t = tor.OctreeRenderOptions(step_size=1e-2, stop_thresh=stop_thresh, color_mode=color_mode)
    cot = np.random.default_rng(10).standard_normal((48, 5)).astype(np.float32)

    def jloss(data):
        out = jor.volume_render_octree(replace(jt, data=data), jr, opts_j, return_depth=True)
        return jnp.sum(jnp.concatenate([out["rgb"], out["acc"][:, None], out["depth"][:, None] / 4], -1) * cot), out

    (_, want), g_want = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jt.data)
    data = tt.data.clone().requires_grad_(True)
    got = tor.volume_render_octree(tt.replace(data=data), tr, opts_t, return_depth=True, slice_steps=16)
    loss = torch.sum(torch.cat([got["rgb"], got["acc"][:, None], got["depth"][:, None] / 4], -1)
                     * torch.from_numpy(cot))
    (g_got,) = torch.autograd.grad(loss, data)
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL * 4)
    assert 0.05 < float(got["acc"].detach().mean()) < 0.95  # rays that stop, rays that pass
    g_want = np.asarray(g_want)
    scale = np.abs(g_want).max()
    assert scale > 0
    np.testing.assert_allclose(g_got.numpy(), g_want, rtol=0, atol=TOL * scale)


def test_render_image_octree_matches_jax():
    jt, tt = tree_pair(11, data_dim=4, quiet_rim=True)
    K = np.array([[12.0, 0, 6.0], [0, 12.0, 5.0], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.1, 3.0]
    opts = dict(step_size=2e-2)
    want = jor.render_image_octree(jt, 10, 12, K, c2w, jor.OctreeRenderOptions(**opts), chunk=64)
    got = tor.render_image_octree(tt, 10, 12, K, c2w, tor.OctreeRenderOptions(**opts), chunk=50)
    assert tuple(got.shape) == (10, 12, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_infer_sh_deg_and_options_match_jax():
    for d in (4, 13, 28, 49):
        assert tor.infer_sh_deg(d) == jor.infer_sh_deg(d)
    with pytest.raises(ValueError):
        tor.infer_sh_deg(10)
    assert tor.OctreeRenderOptions()._asdict() == jor.OctreeRenderOptions()._asdict()
    assert os.path.basename(native._lib()._name).startswith("native_ops-")
