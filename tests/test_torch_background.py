"""The port's background models (``ops/background.py``), their npz keys
(``SparseGrid.save(background=)``) and ``sparsify_background`` against the
JAX package (CPU): every function on the same seeded numpy inputs, the
MSI data's gradient through ``render_background`` against ``jax.grad``,
and checkpoints written by either package read by the other. Float32 on
both sides (tolerances 1e-5, sums in another order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.models import grid_lifecycle as jlc
from nerf_projects_tpu.models.sparse_grid import SparseGrid as JaxSparseGrid
from nerf_projects_tpu.ops import background as jbgm
from nerf_projects_tpu_torch.models import grid_lifecycle as tlc
from nerf_projects_tpu_torch.models.sparse_grid import SparseGrid
from nerf_projects_tpu_torch.ops import background as tbgm
from tests.test_torch_grid import close, random_grids
from tests.test_torch_grid_eval import np_, random_msi, random_reference_bg

TOL = dict(rtol=1e-5, atol=1e-5)
N = 64


def unit_dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def msi_rays(seed, n=N, radius=2.5):
    """Rays from inside the innermost layer (MSI rays start inside it)."""
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-1.0, 1.0, (n, 3)) * radius / np.sqrt(3.0)).astype(np.float32)
    d = unit_dirs(n, seed + 1) * rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return o, d, t


def test_msi_create_and_from_numpy_match_jax():
    jm = jbgm.BackgroundMSI.create(5, 6, inner_radius=2.0, init_density=0.3)
    tm = tbgm.BackgroundMSI.create(5, 6, inner_radius=2.0, init_density=0.3, device="cpu")
    np.testing.assert_array_equal(tm.data.numpy(), np.asarray(jm.data))
    np.testing.assert_array_equal(tm.radii, jm.radii)
    assert tm.radii.dtype == np.float32
    back = tbgm.BackgroundMSI.from_numpy(np.asarray(jm.data), jm.radii, device="cpu")
    np.testing.assert_array_equal(back.data.numpy(), np.asarray(jm.data))


def test_sample_equirect_matches_jax_and_wraps_the_longitude():
    img = np.random.default_rng(50).standard_normal((6, 12, 4)).astype(np.float32)
    d = unit_dirs(N, 51)
    # directions at the seam (longitude +-pi: x = 0, -z) read both edges
    d[:4] = [[1e-4, 0.1, 1.0], [-1e-4, 0.1, 1.0], [1e-4, -0.7, 1.0], [0.0, 0.2, 1.0]]
    d[:4] /= np.linalg.norm(d[:4], axis=-1, keepdims=True)
    got = tbgm.sample_equirect(torch.from_numpy(img), torch.from_numpy(d))
    close(got, jbgm.sample_equirect(jnp.asarray(img), jnp.asarray(d)), **TOL)
    x = tbgm._equirect_uv(torch.from_numpy(d[:2]))[0] * 12 - 0.5
    assert float(x[0]) > 11.0 and float(x[1]) < 0.0  # both between the last column and the first
    close(got[0], np_(got[1]), rtol=0, atol=1e-3)  # ~half of each, either side of the seam


def test_render_background_and_its_gradient_match_jax():
    jm, tm = random_msi(52)
    o, d, t = msi_rays(53)
    want = jbgm.render_background(jm, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), background_brightness=0.3)
    data = tm.data.clone().requires_grad_(True)
    got = tbgm.render_background(tbgm.BackgroundMSI(data, tm.radii), torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(t), background_brightness=0.3)
    close(got, want, **TOL)
    cot = np.random.default_rng(54).standard_normal((N, 3)).astype(np.float32)

    def loss(x):
        return jnp.sum(jbgm.render_background(jm._replace(data=x), jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                                              background_brightness=0.3) * cot)

    g_want = np.asarray(jax.grad(loss)(jm.data))
    (g_got,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(cot)), data)
    scale = np.abs(g_want).max()
    assert scale > 0 and np.abs(g_got.numpy() - g_want).max() < 1e-5 * scale


def test_equirect_maps_match_jax_and_invert():
    d = unit_dirs(N, 55)
    xy = tbgm.xyz2equirect(torch.from_numpy(d), 8)
    close(xy, jbgm.xyz2equirect(jnp.asarray(d), 8), **TOL)
    close(tbgm.equirect2xyz(xy, 8), jbgm.equirect2xyz(jnp.asarray(np_(xy)), 8), **TOL)
    close(tbgm.equirect2xyz(xy, 8), d, rtol=0, atol=1e-5)


def test_sample_reference_background_matches_jax_and_reads_pruned_texels_as_zero():
    jb, tb = random_reference_bg(56)
    d = unit_dirs(N, 57)
    invr = np.random.default_rng(58).uniform(0.0, 1.0, N).astype(np.float32)
    got = tbgm.sample_reference_background(tb, torch.from_numpy(d), torch.from_numpy(invr))
    close(got, jbgm.sample_reference_background(jb, jnp.asarray(d), jnp.asarray(invr)), **TOL)
    pruned = tbgm.ReferenceBackground(tb.data + 1.0, torch.full_like(tb.links, -1))
    assert float(tbgm.sample_reference_background(pruned, torch.from_numpy(d), torch.from_numpy(invr)).abs().max()) == 0


@pytest.mark.parametrize("step_size", [0.5, 1.0])
def test_render_background_reference_matches_jax(step_size):
    jb, tb = random_reference_bg(59)
    o, d, t = msi_rays(60, radius=0.8)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)  # unit dirs, as the reference assumes
    kw = dict(radius=np.array([1.0, 0.9, 1.1], np.float32), center=np.array([0.1, 0.0, -0.1], np.float32),
              step_size=step_size, background_brightness=0.7)
    want = jax.jit(functools.partial(jbgm.render_background_reference, **kw))(
        jb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    got = tbgm.render_background_reference(tb, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t), **kw)
    close(got, want, **TOL)


def test_reference_to_msi_matches_jax():
    jb, tb = random_reference_bg(61)
    jm, tm = jbgm.reference_to_msi(jb), tbgm.reference_to_msi(tb)
    close(tm.data, jm.data, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tm.radii, jm.radii)


def test_background_tv_loss_matches_jax():
    jm, tm = random_msi(62)
    close(tbgm.background_tv_loss(tm), jbgm.background_tv_loss(jm), **TOL)


def test_npz_background_keys_round_trip_across_the_packages(tmp_path):
    """A grid saved by the port with a background loads in the JAX
    package, and the other way round; both background keys survive."""
    jg, tg = random_grids(8, 4, seed=63)
    jb, tb = random_reference_bg(64)
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tg.save(tpath, background=tb)
    jg.save(jpath, background=jb)
    for path in (tpath, jpath):
        jback = jbgm.load_reference_background(path)
        tback = tbgm.load_reference_background(path, device="cpu")
        np.testing.assert_array_equal(tback.data.numpy(), np.asarray(jb.data))
        np.testing.assert_array_equal(tback.links.numpy(), np.asarray(jb.links))
        np.testing.assert_array_equal(np.asarray(jback.data), np.asarray(jb.data))
        np.testing.assert_array_equal(np.asarray(jback.links), np.asarray(jb.links))
        np.testing.assert_array_equal(SparseGrid.load(path, device="cpu").links.numpy(),
                                      np.asarray(JaxSparseGrid.load(path).links))
    tg.save(tpath)
    assert tbgm.load_reference_background(tpath, device="cpu") is None
    assert jbgm.load_reference_background(tpath) is None
    d = {}
    tbgm.save_reference_background(d, tb)
    assert d["background_data"].dtype == np.float32 and d["background_links"].dtype == np.int32


@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_sparsify_background_equals_jax(dilate):
    jm, _ = random_msi(65, nlayers=6, reso=8)
    data = np.array(jm.data)
    data[..., 3] *= 0.5
    data[2, 2:4, 4:6, 3] = 2.0  # one block above the threshold: dilated, it still leaves texels out
    jm = jm._replace(data=jnp.asarray(data))
    tm = tbgm.BackgroundMSI.from_numpy(data, jm.radii, device="cpu")
    want = jlc.sparsify_background(jm, sigma_thresh=1.6, dilate=dilate)
    got = tlc.sparsify_background(tm, sigma_thresh=1.6, dilate=dilate)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.radii, want.radii)
    zeroed = (got.data == 0).all(-1).float().mean()
    assert 0 < float(zeroed) < 1
