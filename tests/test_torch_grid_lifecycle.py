"""The port's grid lifecycle (``models/grid_lifecycle.py``) and
``pipeline/extraction.py::grid_weight_render`` on the CPU against the JAX
package on the same seeded grids: dilation and the skip grid exactly,
resample on both mask paths with equal links and data within 1e-5, the
largest-ray-weight render within 1e-5 with its ties at the threshold
counted, and the PlenOctree export and bake (``to_octree``,
``octree_to_grid``)."""
import numpy as np
import pytest
import torch

from nerf_projects_tpu.models import grid_lifecycle as jgl
from nerf_projects_tpu.pipeline import extraction as jex
from nerf_projects_tpu_torch.data.synthetic import make_dataset
from nerf_projects_tpu_torch.models import grid_lifecycle as tgl
from nerf_projects_tpu_torch.pipeline import extraction as tex
from tests.test_torch_tile_march import np_, random_grids

TOL = 1e-5


@pytest.mark.parametrize("iterations", [0, 1, 2])
def test_dilate_mask_matches_jax(iterations):
    m = np.random.default_rng(iterations).uniform(size=(12, 10, 9)) > 0.97
    np.testing.assert_array_equal(tgl.dilate_mask(m, iterations), jgl.dilate_mask(m, iterations))


@pytest.mark.parametrize("kind", ["random", "full", "empty"])
def test_compute_skip_grid_matches_jax(kind):
    rng = np.random.default_rng(3)
    links = np.where(rng.uniform(size=(10, 12, 8)) > 0.95, 0, -1).astype(np.int32)
    if kind == "full":
        links[:] = 0
    elif kind == "empty":
        links[:] = -1
    got, want = tgl.compute_skip_grid(links), jgl.compute_skip_grid(links)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_resample_sigma_path_matches_jax():
    """Upsampling 16^3 -> 24^3 (and 16^3 -> 12^3, odd sizes) on the
    sigma threshold: the same links, the trilinear data within 1e-5."""
    jg, tg = random_grids(16, 4, seed=5, dens_hi=6.0)
    for reso, thresh, dilate in ((24, 4.0, 1), ((12, 14, 10), 3.0, 2)):
        want = jgl.resample(jg, reso, sigma_thresh=thresh, dilate=dilate)
        got = tgl.resample(tg, reso, sigma_thresh=thresh, dilate=dilate, batch_size=4096)
        assert got.reso == want.reso and got.basis_dim == 4
        np.testing.assert_array_equal(np_(got.links), np.asarray(want.links))
        np.testing.assert_allclose(np_(got.density_data), np.asarray(want.density_data), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(np_(got.sh_data), np.asarray(want.sh_data), rtol=TOL, atol=TOL)
        assert 0 < got.capacity < np.prod(got.reso)
    # a threshold no cell meets keeps the densest one
    lone = tgl.resample(tg, 12, sigma_thresh=1e9, dilate=0)
    assert lone.capacity == 1 and lone.capacity == jgl.resample(jg, 12, sigma_thresh=1e9, dilate=0).capacity


@pytest.fixture(scope="module")
def cameras():
    ds = make_dataset(n_views=2, image_size=24, device="cpu")
    return [(ds["poses"][v], ds["intrinsics"], 24, 24) for v in range(2)]


def test_grid_weight_render_matches_jax(cameras):
    """The largest ray weight per cell within 1e-5 (the port sums the
    transmittance in slices of steps, JAX one step at a time), and the
    masks at a threshold equal but on the ties: cells within 1e-5 of it
    (none here)."""
    rng = np.random.default_rng(6)
    sig = np.maximum(rng.standard_normal((16, 16, 16)) * 20.0, 0.0).astype(np.float32)
    pose = np.asarray(cameras[0][0], np.float64).copy()
    pose[:3, 3] /= 1.5
    pose = pose.astype(np.float32)
    want = jex.grid_weight_render(sig, pose, cameras[0][1], 24, 24, step_size=1e-2, ray_subsample=2)
    got = tex.grid_weight_render(sig, pose, cameras[0][1], 24, 24, step_size=1e-2, ray_subsample=2, device="cpu")
    assert got.shape == (16, 16, 16) and got.max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    thresh = 0.01
    ties = np.abs(want - thresh) <= TOL
    assert int(ties.sum()) == 0
    np.testing.assert_array_equal((got >= thresh)[~ties], (want >= thresh)[~ties])


def test_resample_weight_path_matches_jax(cameras):
    """The camera-weight mask (the CLI's default thresh_type) with a
    top-k bound: the same links, the data within 1e-5."""
    jg, tg = random_grids(16, 1, seed=7, dens_hi=3.0)
    kw = dict(cameras=cameras, weight_thresh=1e-3, dilate=1)
    want = jgl.resample(jg, 20, **kw)
    got = tgl.resample(tg, 20, **kw)
    np.testing.assert_array_equal(np_(got.links), np.asarray(want.links))
    np.testing.assert_allclose(np_(got.density_data), np.asarray(want.density_data), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np_(got.sh_data), np.asarray(want.sh_data), rtol=TOL, atol=TOL)
    assert 50 < got.capacity < 20**3  # the mask keeps part of the grid
    kept = tgl.resample(tg, 20, max_elements=50, **kw)
    assert kept.capacity == jgl.resample(jg, 20, max_elements=50, **kw).capacity


@pytest.mark.parametrize("basis_dim", [1, 9, 16])
def test_resize_matches_jax(basis_dim):
    jg, tg = random_grids(8, 4, seed=8)
    want = jgl.resize(jg, basis_dim)
    got = tgl.resize(tg, basis_dim)
    assert got.basis_dim == basis_dim
    np.testing.assert_array_equal(np_(got.sh_data), np.asarray(want.sh_data))
    with pytest.raises(ValueError, match="square"):
        tgl.resize(tg, 5)


@pytest.fixture(scope="module")
def exported():
    """A 16^3 grid (basis 4) exported by both packages' to_octree, once
    for the tests below (JAX compiles its descent at every refine)."""
    jg, tg = random_grids(16, 4, seed=10)
    return jg, tg, jgl.to_octree(jg), tgl.to_octree(tg)


@pytest.mark.parametrize("sigma_thresh,depth", [(0.0, None), (3.0, 3)])
def test_to_octree_matches_jax(exported, sigma_thresh, depth):
    """svox2's to_svox1 on a 16^3 grid (every occupied cell, or those with
    density >= 3, at the default depth or one coarser): the same topology
    bits, the finest leaves' payload within 1e-6."""
    jg, tg, want, got = exported
    if sigma_thresh or depth is not None:
        want = jgl.to_octree(jg, depth=depth, sigma_thresh=sigma_thresh)
        got = tgl.to_octree(tg, depth=depth, sigma_thresh=sigma_thresh)
    np.testing.assert_array_equal(got.child_host, np.asarray(want.child))
    np.testing.assert_array_equal(got.offset, want.offset)
    assert got.depth_limit == want.depth_limit and got.n_nodes > 100
    np.testing.assert_allclose(np_(got.data), np.asarray(want.data), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_octree_to_grid_matches_jax(exported, dilate):
    """The bake at the tree's finest resolution, the mask (sigma above 2)
    dilated 0-2 cells: the same links and the same data bits; then the
    round trip of to_octree: every occupied cell's density and SH back
    equal."""
    jg, tg, jt, tt = exported
    want = jgl.octree_to_grid(jt, sigma_thresh=2.0, dilate=dilate)
    got = tgl.octree_to_grid(tt, sigma_thresh=2.0, dilate=dilate, batch=1000)
    assert got.reso == want.reso == (16, 16, 16) and got.basis_dim == 4
    np.testing.assert_array_equal(got.radius, want.radius)
    np.testing.assert_array_equal(got.center, want.center)
    np.testing.assert_array_equal(np_(got.links), np.asarray(want.links))
    np.testing.assert_array_equal(np_(got.density_data), np.asarray(want.density_data))
    np.testing.assert_array_equal(np_(got.sh_data), np.asarray(want.sh_data))
    back = tgl.octree_to_grid(tt, dilate=0)
    occ = np_(tg.links) >= 0
    rows, rows_back = np_(tg.links)[occ], np_(back.links)[occ]
    assert (rows_back >= 0).all()
    np.testing.assert_array_equal(np_(back.density_data)[rows_back], np_(tg.density_data)[rows])
    np.testing.assert_array_equal(np_(back.sh_data)[rows_back], np_(tg.sh_data)[rows])
    if dilate == 0:  # a threshold no cell passes keeps the densest one, as JAX's
        lone = tgl.octree_to_grid(tt, sigma_thresh=1e9, dilate=0)
        assert lone.capacity == jgl.octree_to_grid(jt, sigma_thresh=1e9, dilate=0).capacity == 1


def test_sparsify_background_is_exported():
    # sparsify_background (item 4) is ported: tests/test_torch_background.py holds it to JAX's
    from nerf_projects_tpu_torch.ops.background import BackgroundMSI

    msi = BackgroundMSI.create(2, 4, device="cpu")
    assert tgl.sparsify_background(msi, sigma_thresh=0.05).data.shape == msi.data.shape


def test_grid_weight_render_runs_on_the_card_unless_asked():
    args = (np.zeros((4, 4, 4), np.float32), np.eye(4, dtype=np.float32), np.eye(3, dtype=np.float32), 4, 4)
    if torch.cuda.is_available():
        assert tex.grid_weight_render(*args).shape == (4, 4, 4)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tex.grid_weight_render(*args)
