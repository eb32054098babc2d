"""The port's PlenOctree pipeline on the CPU against the JAX package on the
same seeded numpy inputs: extraction (``pipeline/extraction.py``), the SH
projection (``ops/sh.py``), finetuning (``pipeline/optimization.py``),
compression (``pipeline/compression.py``) and meshes
(``pipeline/mesh.py``). ``to_octree`` and ``octree_to_grid`` are held in
``tests/test_torch_grid_lifecycle.py``.

Levels: extraction bit for bit on the analytic sphere scene (the tree and
its data) and within 1e-5 on a narrow NeRF-SH carried from flax
(``nerf_sh_flax_to_state_dict``) in the sigma, weight and RGBA modes,
with the same topology; the projections within 1e-5; one SGD and one
Adam update of ``OctreeFinetuner`` (with and without NDC rays) as updates
within 1e-4 of their largest (plus the new values' float32 rounding); ``finetune_fast``'s bake bit for bit and
its write-back within 1e-6, its training (the plain K3 and K4 here) to its
own val PSNR rise; compression's files bit for bit both ways; the mesh
bit for bit.
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.core.rays import Rays as JRays
from nerf_projects_tpu.data.base import SceneData as JSceneData
from nerf_projects_tpu.data.synthetic import default_scene as jdefault_scene, scene_fields as jscene_fields
from nerf_projects_tpu.models import grid_lifecycle as jgl
from nerf_projects_tpu.models import nerf_sh as jsh
from nerf_projects_tpu.ops import grid as jgrid
from nerf_projects_tpu.ops import octree_render as jor
from nerf_projects_tpu.ops import sh as jshops
from nerf_projects_tpu.pipeline import compression as jcomp
from nerf_projects_tpu.pipeline import extraction as jex
from nerf_projects_tpu.pipeline import mesh as jmesh
from nerf_projects_tpu.pipeline import optimization as jopt
from nerf_projects_tpu_torch.data.base import SceneData
from nerf_projects_tpu_torch.data.synthetic import default_scene, make_dataset, scene_fields
from nerf_projects_tpu_torch.models import grid_lifecycle as tgl
from nerf_projects_tpu_torch.models import nerf_sh as tsh
from nerf_projects_tpu_torch.ops import octree_render as tor
from nerf_projects_tpu_torch.ops import sh as tshops
from nerf_projects_tpu_torch.pipeline import compression as tcomp
from nerf_projects_tpu_torch.pipeline import extraction as tex
from nerf_projects_tpu_torch.pipeline import mesh as tmesh
from nerf_projects_tpu_torch.pipeline import optimization as topt
from tests.test_torch_fused_mlp import random_biases
from tests.test_torch_octree import tree_pair
from tests.test_torch_tile_march import np_

TOL = 1e-5
NARROW = dict(num_coarse_samples=4, num_fine_samples=4, use_viewdirs=False, net_depth=2, net_width=32,
              max_deg_point=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def analytic_evals(sh_deg=0):
    """The sphere scene as deg-0 SH coefficients whose sigmoid decode is
    the scene's colour, in both packages (tests/test_pipeline.py:74-88)."""
    def jf(pts):
        rgb, sigma = jscene_fields(jdefault_scene(), pts)
        rgb = jnp.clip(rgb, 1e-4, 1 - 1e-4)
        return jnp.log(rgb / (1 - rgb)) / jshops.SH_C0, sigma[:, None]

    def tf(pts):
        rgb, sigma = scene_fields(default_scene(), pts)
        rgb = torch.clamp(rgb, 1e-4, 1 - 1e-4)
        return torch.log(rgb / (1 - rgb)) / tshops.SH_C0, sigma[:, None]

    return jax.jit(jf), tf


def scenes(n_views=3, size=16, **kw):
    ds = make_dataset(n_views=n_views, image_size=size, device="cpu", **kw)
    arrays = dict(images=ds["images"].numpy(), poses=ds["poses"], intrinsics=ds["intrinsics"], near=ds["near"],
                  far=ds["far"])
    return SceneData(**arrays), JSceneData(**arrays)


def assert_same_tree(got, want, tol=None):
    np.testing.assert_array_equal(got.child_host, np.asarray(want.child))
    np.testing.assert_array_equal(got.invradius, want.invradius)
    np.testing.assert_array_equal(got.offset, want.offset)
    assert got.depth_limit == want.depth_limit
    if tol is None:
        np.testing.assert_array_equal(np_(got.data), np.asarray(want.data))
    else:
        np.testing.assert_allclose(np_(got.data), np.asarray(want.data), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def test_extract_analytic_scene_bit_for_bit():
    """auto_scale's box, then extraction at depth 3 in that box: the same
    topology and data bits (the same cell centres and step-2 points, the
    sample mean in numpy's order)."""
    jf, tf = analytic_evals()
    want_box = jex.auto_scale(jf, (0.0, 0.0, 0.0), 1.5, init_grid_depth=4, chunk=1000)
    got_box = tex.auto_scale(tf, (0.0, 0.0, 0.0), 1.5, init_grid_depth=4, chunk=1000, device="cpu")
    assert got_box == want_box and want_box[1][0] < 1.0
    center, radius = want_box[0], [r * 1.05 for r in want_box[1]]
    kw = dict(center=center, radius=radius, data_dim=4, init_grid_depth=3, chunk=2048, seed=5)
    want = jex.extract_octree(jf, **kw)
    stats = {}
    got = tex.extract_octree(tf, device="cpu", stats=stats, **kw)
    assert_same_tree(got, want)
    assert got.n_nodes > 50 and 0.05 < stats["masked_share"] < 0.6 and stats["finest_leaves"] > 100
    # nothing masked: a single root, as JAX's
    empty = tex.extract_octree(lambda p: tf(p * 0 + 10.0), device="cpu", **kw)
    assert empty.n_nodes == 1 and float(empty.data.abs().sum()) == 0.0


@functools.lru_cache(maxsize=None)
def _narrow_pair(seed, **kw):
    """A narrow NeRF-SH from flax's init (random biases) and the port's
    model holding the same weights: their eval_points_raw (JAX's jitted,
    shared by the tests that use the same model)."""
    jmodel = jsh.NeRFSHModel(**NARROW, **kw)
    rays = JRays(*(jnp.asarray(np.eye(3, dtype=np.float32)[:2]) for _ in range(3)))
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = jax.jit(lambda a, b, c, r: jmodel.init(a, b, c, r, False))(k[0], k[1], k[2], rays)
    params = random_biases(jax.tree_util.tree_map(np.asarray, params), seed, std=0.5)
    port = tsh.NeRFSHModel(**NARROW, **kw)
    port.load_state_dict(tsh.nerf_sh_flax_to_state_dict(params), strict=True)
    jf = jax.jit(lambda pts: jmodel.apply(params, pts, method=jmodel.eval_points_raw))
    return jf, port.eval_points_raw


@pytest.mark.parametrize("mode", ["sigma", "weight", "rgba"])
def test_extract_narrow_nerf_sh_matches_jax(mode):
    """sh_deg 1 (the weight mask on a camera of make_dataset's
    scene) or, in RGBA mode, the plain rgb head: the same topology (no
    sigma or weight within 1e-5 of the threshold), the data within 1e-5."""
    sh = dict(sh_deg=-1) if mode == "rgba" else dict(sh_deg=1)
    jf, tf = _narrow_pair(11 if mode == "rgba" else 5, **sh)
    if mode == "rgba":
        # densities relu'd, as a model's decoded eval gives them: raw ones of
        # both signs make the alpha sum that divides the rgb mean cancel
        jf0, tf0 = jf, tf
        jf = jax.jit(lambda p: (jf0(p)[0], jnp.maximum(jf0(p)[1], 0.0)))
        tf = lambda p: (tf0(p)[0], torch.relu(tf0(p)[1]))  # noqa: E731
    kw = dict(center=(0.0, 0.1, 0.0), radius=1.3, data_dim=4 if mode == "rgba" else 13, init_grid_depth=2,
              chunk=1024, rgba_mode=mode == "rgba", samples_per_cell=4)
    dataset = jdataset = None
    if mode == "weight":
        dataset, jdataset = scenes(n_views=1, size=24)
        kw.update(masking_mode="weight", weight_thresh=1e-3, renderer_step_size=1e-2)
    reso = 8
    jt0 = jex.PlenOctree.create(kw["data_dim"], center=kw["center"], radius=kw["radius"])
    sig = jex._chunked_sigma_eval(jf, jex._cell_center_grid(reso, jt0.invradius, jt0.offset), 1024)
    if mode != "weight":
        thresh = -np.log(1.0 - 0.01) / (2.0 / reso)
        assert np.abs(sig - thresh).min() > TOL and 0.05 < (sig >= thresh).mean() < 0.9
    want = jex.extract_octree(jf, dataset=jdataset, **kw)
    got = tex.extract_octree(tf, dataset=dataset, device="cpu", **kw)
    assert got.n_nodes > 9
    assert_same_tree(got, want, tol=TOL)


def test_sh_projection_matches_jax(monkeypatch):
    """project_function_sh and its least-squares variant on the same
    samples; make_sh_projection_eval_fn with JAX's directions patched in
    (the two packages draw them from different generators)."""
    rng = np.random.default_rng(12)
    vals = rng.uniform(0, 1, (7, 50, 3)).astype(np.float32)
    jdirs_of = jax.jit(jshops.spherical_uniform_dirs, static_argnums=1)
    dirs = np.array(jdirs_of(jax.random.PRNGKey(3), 50))
    for deg in (1, 3):
        for jfn, tfn in ((jax.jit(jshops.project_function_sh, static_argnums=2), tshops.project_function_sh),
                         (jax.jit(jshops.project_function_sh_lstsq, static_argnums=2),
                          tshops.project_function_sh_lstsq)):
            want = jfn(jnp.asarray(vals), jnp.asarray(dirs), deg)
            got = tfn(torch.from_numpy(vals), torch.from_numpy(dirs), deg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    d = tshops.spherical_uniform_dirs(1000, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(torch.linalg.norm(d, dim=-1).numpy(), 1.0, atol=1e-6)
    assert abs(float(d[:, 2].mean())) < 0.1

    A = rng.standard_normal((3, 3)).astype(np.float32)
    B = rng.standard_normal((3, 3)).astype(np.float32)

    def jcross(pts, dd):
        rgb = jax.nn.sigmoid((pts @ A)[:, None, :] + (dd @ B)[None])
        return rgb, jnp.abs(pts).sum(-1, keepdims=True)

    def tcross(pts, dd):
        rgb = torch.sigmoid((pts @ torch.from_numpy(A))[:, None, :] + (dd @ torch.from_numpy(B))[None])
        return rgb, pts.abs().sum(-1, keepdim=True)

    jfn = jex.make_sh_projection_eval_fn(jcross, 2, projection_samples=64, seed=4)
    jdirs = np.array(jdirs_of(jax.random.PRNGKey(4), 64))
    monkeypatch.setattr(tex, "spherical_uniform_dirs", lambda n, gen, dev: torch.from_numpy(jdirs))
    tfn = tex.make_sh_projection_eval_fn(tcross, 2, projection_samples=64, seed=4, device="cpu")
    pts = rng.uniform(-1, 1, (9, 3)).astype(np.float32)
    (wc, ws), (gc, gs) = jax.jit(jfn)(jnp.asarray(pts)), tfn(torch.from_numpy(pts))
    assert tuple(gc.shape) == (9, 27)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-4, atol=TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# finetuning
# ---------------------------------------------------------------------------

def _forward_scene():
    """Two 8x8 views looking down -z from z = 0.5 (forward facing, for the
    NDC rays too)."""
    K = np.array([[6.0, 0, 4.0], [0, 6.0, 4.0], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[:, :3, 3] = [[0.0, 0.0, 0.5], [0.1, -0.1, 0.5]]
    images = np.random.default_rng(13).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    arrays = dict(images=images, poses=poses, intrinsics=K, near=0.5, far=4.0)
    return SceneData(**arrays), JSceneData(**arrays)


def _held_update(got_old, got_new, want_old, want_new, where=None):
    """new - old on both sides within 1e-4 of the largest update, plus two
    float32 spacings of the old value (the new value's own rounding: a
    sigma of 30 keeps updates to ~2e-6)."""
    old = np.asarray(want_old)
    du, dw = np_(got_new) - np_(got_old), np.asarray(want_new) - old
    scale = np.abs(dw).max()
    assert scale > 0
    bound = 1e-4 * scale + 2 * np.spacing(np.abs(old))
    if where is not None:
        du, dw, bound = du[where], dw[where], bound[where]
    assert np.all(np.abs(du - dw) <= bound), np.abs(du - dw).max()


@functools.lru_cache(maxsize=None)
def _jax_step(optimizer, lr):
    """JAX's jitted finetuning step on tree_pair(14), once per optimizer
    (the NDC cases differ only in their rays)."""
    jt, _ = tree_pair(14, quiet_rim=True)
    return jopt.OctreeFinetuner(jor.OctreeRenderOptions(step_size=2e-2), optimizer=optimizer, lr=lr,
                                chunk=80)._make_step(jt)


@pytest.mark.parametrize("ndc", [False, True], ids=["world", "ndc"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_finetuner_update_matches_jax(optimizer, ndc):
    """One update on a view's 64 rays, padded to a chunk of 80 by the last
    ray (as JAX pads), compared as updates: SGD at lr 1e7 everywhere, Adam
    at lr 1e-2 where |g| > 100 eps (elsewhere eps decides)."""
    jt, tt = tree_pair(14, quiet_rim=True)
    scene, jscene = _forward_scene()
    lr = 1e7 if optimizer == "sgd" else 1e-2
    kw = dict(optimizer=optimizer, lr=lr, chunk=80, ndc=(8, 8, 6.0) if ndc else None)
    jft = jopt.OctreeFinetuner(jor.OctreeRenderOptions(step_size=2e-2), **kw)
    tft = topt.OctreeFinetuner(tor.OctreeRenderOptions(step_size=2e-2), **kw)
    jrays = jft._image_rays(jscene, 1)
    trays = tft._image_rays(scene, 1, "cpu")
    jstep = _jax_step(optimizer, lr)
    np.testing.assert_allclose(trays.origins.numpy(), np.asarray(jrays.origins), rtol=TOL, atol=TOL)
    pad = lambda x: jnp.pad(x, ((0, 16), (0, 0)), mode="edge")  # noqa: E731
    jsl = jax.tree_util.tree_map(pad, jrays)
    tgt = jnp.asarray(jscene.images[1].reshape(-1, 3))
    jstate = (jnp.zeros_like(jt.data), jnp.zeros_like(jt.data), 0) if optimizer == "adam" else None
    jdata, jstate2, jmse = jstep(jt.data, jstate, jsl, pad(tgt))
    tsl = trays.map(lambda x: topt._pad_rows(x, 80))
    ttgt = topt._pad_rows(torch.from_numpy(scene.images[1].reshape(-1, 3)), 80)
    tdata, tstate2, tmse = tft.step(tt, tt.data, tft.init_state(tt), tsl, ttgt)
    assert abs(float(tmse) - float(jmse)) <= 1e-5 * float(jmse)
    where = None
    if optimizer == "adam":
        g = np.asarray(jstate2[0]) / 0.1  # m = 0.1 g after one step
        where = np.abs(g) > 100 * 1e-8
        assert tstate2[2] == jstate2[2] == 1 and where.sum() > 10
        np.testing.assert_allclose(np_(tstate2[0]), np.asarray(jstate2[0]), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(jstate2[0])).max())
    _held_update(tt.data, tdata, jt.data, jdata, where)


def test_finetuner_eval_psnr_and_finetune_match_jax():
    """eval_psnr on the same tree, and a 1-epoch SGD finetune with val
    every epoch: JAX's update of the data (as updates, as above); the
    PSNR rises."""
    jt, tt = tree_pair(15, quiet_rim=True)
    scene, jscene = _forward_scene()
    kw = dict(lr=1e2, chunk=64)
    jft = jopt.OctreeFinetuner(jor.OctreeRenderOptions(step_size=2e-2), **kw)
    tft = topt.OctreeFinetuner(tor.OctreeRenderOptions(step_size=2e-2), **kw)
    assert abs(tft.eval_psnr(tt, scene) - jft.eval_psnr(jt, jscene)) < 1e-3
    jt2 = jft.finetune(jt, jscene, jscene, n_epochs=1, val_interval=1)
    tt2 = tft.finetune(tt, scene, scene, n_epochs=1, val_interval=1)
    # the finetuned data held directly (a second JAX eval_psnr would compile again)
    _held_update(tt.data, tt2.data, jt.data, jt2.data)
    assert tft.eval_psnr(tt2, scene) > tft.eval_psnr(tt, scene)


def _jax_write_back(jt, jgrid_):
    """The write-back lines of JAX's finetune_fast (optimization.py:325-339)."""
    cells, _, corners, sizes = jt.leaf_depths_and_corners()
    world = ((corners + sizes[:, None] * 0.5 - jt.offset) / jt.invradius).astype(np.float32)
    density, sh = jgrid.sample_grid(jgrid_, jnp.asarray(world))
    data = np.array(jt.data)
    data[cells[:, 0], cells[:, 1], cells[:, 2], cells[:, 3], :-1] = np.asarray(sh)
    data[cells[:, 0], cells[:, 1], cells[:, 2], cells[:, 3], -1:] = np.asarray(density)
    return data


def test_finetune_fast_bake_and_write_back_match_jax():
    """The bake (octree_to_grid at the finest resolution) bit for bit;
    the leaves resampled from a grid within 1e-6 of JAX's."""
    jt, tt = tree_pair(16)
    want, got = jgl.octree_to_grid(jt), tgl.octree_to_grid(tt)
    np.testing.assert_array_equal(np_(got.links), np.asarray(want.links))
    np.testing.assert_array_equal(np_(got.density_data), np.asarray(want.density_data))
    np.testing.assert_array_equal(np_(got.sh_data), np.asarray(want.sh_data))
    rng = np.random.default_rng(17)
    jg = replace(want, sh_data=jnp.asarray(rng.standard_normal(want.sh_data.shape).astype(np.float32)))
    tg = replace(got, sh_data=torch.from_numpy(np.array(jg.sh_data)))
    np.testing.assert_allclose(np_(topt.write_back(tt, tg).data), _jax_write_back(jt, jg), rtol=1e-6, atol=1e-6)


def test_finetune_fast_raises_val_psnr():
    """finetune_fast (the plain K3 and K4 on the CPU) on a tree extracted
    from the analytic scene with noise added: two epochs raise the baked
    grid's val PSNR, the topology stays, the returned tree renders."""
    _, tf = analytic_evals()
    tree = tex.extract_octree(tf, radius=1.0, data_dim=4, init_grid_depth=3, chunk=4096, samples_per_cell=2,
                              device="cpu")
    noise = torch.from_numpy(np.random.default_rng(18).normal(0, 0.6, tuple(tree.data.shape)).astype(np.float32))
    tree = tree.replace(data=tree.data + noise * (tree.data[..., -1:] > 0))
    scene, _ = scenes(n_views=3, size=16)
    stats = {}
    out = topt.finetune_fast(tree, scene, scene, n_epochs=2, val_interval=1, tiles_per_batch=4, lr_sigma=3e0,
                             stats=stats)
    assert len(stats["val_psnr"]) == 2 and stats["val_psnr"][-1] > stats["initial_val_psnr"] + 0.5, stats
    np.testing.assert_array_equal(out.child_host, tree.child_host)
    assert np.isfinite(topt.OctreeFinetuner(tor.OctreeRenderOptions(step_size=1e-2)).eval_psnr(out, scene))


# ---------------------------------------------------------------------------
# compression and meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_colors,retain", [(64, 1), (4096, 2)])
def test_compression_files_match_jax_both_ways(tmp_path, n_colors, retain):
    jt, tt = tree_pair(19, sigma_hi=4.0)
    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    kw = dict(n_colors=n_colors, sigma_thresh=1.0, retain=retain)
    want, got = jcomp.compress_octree(jt, jp, **kw), tcomp.compress_octree(tt, tp, **kw)
    assert got["raw_bytes"] == want["raw_bytes"] and got["compression_ratio"] > 1
    zj, zt = np.load(jp), np.load(tp)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zt[k], zj[k])
    assert all(len(zt[f"palette_{b}"]) <= n_colors for b in range(retain, 4))
    for path in (jp, tp):
        assert_same_tree(tcomp.load_compressed_octree(path, device="cpu"), jcomp.load_compressed_octree(path))
    assert tcomp.median_cut(np.zeros((0, 3), np.float32), 4)[0].shape == (1, 3)


def test_marching_tetrahedra_and_obj_match_jax(tmp_path):
    rng = np.random.default_rng(20)
    field = rng.standard_normal((9, 10, 11)).astype(np.float32)
    for iso in (0.3, 10.0):
        (gv, gt), (wv, wt) = tmesh.marching_tetrahedra(field, iso), jmesh.marching_tetrahedra(field, iso)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gt, wt)

    def jsig(p):
        return 30.0 * (jnp.linalg.norm(p, axis=-1) < 0.7)

    def tsig(p):
        return 30.0 * (torch.linalg.norm(p, dim=-1) < 0.7).float()

    want = jmesh.extract_mesh_from_field(jsig, reso=24, radius=1.0, iso=10.0, chunk=1000)
    got = tmesh.extract_mesh_from_field(tsig, reso=24, radius=1.0, iso=10.0, chunk=999, device="cpu")
    assert len(got[1]) > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jmesh.save_obj(str(tmp_path / "j.obj"), *want)
    tmesh.save_obj(str(tmp_path / "t.obj"), *got)
    assert (tmp_path / "j.obj").read_text() == (tmp_path / "t.obj").read_text()
