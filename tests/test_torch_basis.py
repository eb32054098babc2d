"""The port's learned colour bases (``ops/basis.py``) and cubemap maths
(``ops/cubemap.py``) against the JAX package (CPU), on the same seeded
numpy inputs; the spherical Gaussians' draws of ``reinit_learned_basis``
are JAX's, patched in. Float32 on both sides (1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.ops import basis as jbasis
from nerf_projects_tpu.ops import cubemap as jcube
from nerf_projects_tpu_torch.ops import basis as tbasis
from nerf_projects_tpu_torch.ops import cubemap as tcube
from tests.test_torch_grid import close

TOL = dict(rtol=1e-5, atol=1e-5)


def unit_dirs(shape, seed):
    d = np.random.default_rng(seed).standard_normal(shape + (3,)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_eval_basis_3d_matches_jax():
    rng = np.random.default_rng(70)
    data = rng.standard_normal((5, 5, 5, 4)).astype(np.float32)
    d = unit_dirs((6, 7), 71)
    d[0, :3] = [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]]  # on the cube's faces
    close(tbasis.eval_basis_3d(torch.from_numpy(data), torch.from_numpy(d)),
          jbasis.eval_basis_3d(jnp.asarray(data), jnp.asarray(d)), **TOL)
    assert tuple(tbasis.init_basis_3d(6, 4, device="cpu").shape) == (6, 6, 6, 4)
    np.testing.assert_array_equal(tbasis.init_basis_3d(6, 4, device="cpu").numpy(),
                                  np.asarray(jbasis.init_basis_3d(6, 4)))


@pytest.mark.parametrize("n_freqs", [0, 1, 3])
def test_posenc_and_basis_mlp_match_jax(n_freqs):
    d = unit_dirs((40,), 72)
    close(tbasis._posenc_dirs(torch.from_numpy(d), n_freqs), jbasis._posenc_dirs(jnp.asarray(d), n_freqs), **TOL)
    jp = jbasis.init_basis_mlp(jax.random.PRNGKey(n_freqs), 9, mlp_width=16, mlp_posenc_size=n_freqs)
    rng = np.random.default_rng(73)
    jp = {k: v + (rng.normal(0, 0.1, v.shape).astype(np.float32) if k.startswith("b") else 0) for k, v in jp.items()}
    tp = tbasis.mlp_params_from_numpy(jp, device="cpu")
    want = jbasis.eval_basis_mlp(jp, jnp.asarray(d), mlp_posenc_size=n_freqs)
    close(tbasis.eval_basis_mlp(tp, torch.from_numpy(d), mlp_posenc_size=n_freqs), want, **TOL)
    close(tbasis.eval_basis(tbasis.BASIS_TYPE_MLP, 9, torch.from_numpy(d), mlp_params=tp, mlp_posenc_size=n_freqs),
          jbasis.eval_basis(jbasis.BASIS_TYPE_MLP, 9, jnp.asarray(d), mlp_params=jp, mlp_posenc_size=n_freqs), **TOL)


def test_init_basis_mlp_shapes_and_range():
    gen = torch.Generator().manual_seed(0)
    tp = tbasis.init_basis_mlp(gen, 9, mlp_width=16, mlp_posenc_size=2)
    jp = jbasis.init_basis_mlp(jax.random.PRNGKey(0), 9, mlp_width=16, mlp_posenc_size=2)
    assert set(tp) == set(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape) and tp[k].dtype == torch.float32
    for i, fan_in in enumerate((15, 16, 16, 16)):
        w = tp[f"w{i}"]
        assert float(w.abs().max()) <= 1 / np.sqrt(fan_in) and float(w.std()) > 0.2 / np.sqrt(fan_in)
        assert float(tp[f"b{i}"].abs().max()) == 0.0


def test_eval_basis_dispatch_matches_jax():
    d = unit_dirs((30,), 74)
    data = np.random.default_rng(75).standard_normal((4, 4, 4, 9)).astype(np.float32)
    close(tbasis.eval_basis(tbasis.BASIS_TYPE_3D_TEXTURE, 9, torch.from_numpy(d), basis_data=torch.from_numpy(data)),
          jbasis.eval_basis(jbasis.BASIS_TYPE_3D_TEXTURE, 9, jnp.asarray(d), basis_data=jnp.asarray(data)), **TOL)
    close(tbasis.eval_basis(tbasis.BASIS_TYPE_SH, 9, torch.from_numpy(d)),
          jbasis.eval_basis(jbasis.BASIS_TYPE_SH, 9, jnp.asarray(d)), **TOL)


def test_reinit_learned_basis_sh_matches_jax():
    got = tbasis.reinit_learned_basis(tbasis.init_basis_3d(8, 9, device="cpu"), init_type="sh")
    close(got, jbasis.reinit_learned_basis(jbasis.init_basis_3d(8, 9), jax.random.PRNGKey(0), init_type="sh"), **TOL)


@pytest.mark.parametrize("upper_hemi", [False, True])
def test_reinit_learned_basis_sg_matches_jax_on_its_draws(monkeypatch, upper_hemi):
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    mu = np.asarray(jax.random.normal(k1, (4, 3)))
    lam = np.asarray(jax.random.uniform(k2, (4,), minval=0.0, maxval=2.0))
    draws = (torch.from_numpy(mu.copy()), torch.from_numpy(lam.copy()))
    monkeypatch.setattr(tbasis, "_sg_draws", lambda gen, b, lmax: draws)
    got = tbasis.reinit_learned_basis(tbasis.init_basis_3d(6, 4, device="cpu"), torch.Generator(), init_type="sg",
                                      sg_lambda_max=2.0, upper_hemi=upper_hemi)
    want = jbasis.reinit_learned_basis(jbasis.init_basis_3d(6, 4), key, init_type="sg", sg_lambda_max=2.0,
                                       upper_hemi=upper_hemi)
    close(got, want, **TOL)
    with pytest.raises(ValueError, match="init_type"):
        tbasis.reinit_learned_basis(tbasis.init_basis_3d(2, 1, device="cpu"), init_type="nope")


def test_sg_draws_follow_the_generator():
    a = tbasis._sg_draws(torch.Generator().manual_seed(3), 5, 1.5)
    b = tbasis._sg_draws(torch.Generator().manual_seed(3), 5, 1.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tuple(a[0].shape) == (5, 3) and float(a[1].max()) < 1.5 and float(a[1].min()) >= 0


# ---------------------------------------------------------------------------
# Cubemaps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eac", [True, False])
def test_dir_to_cubemap_coord_and_back_match_jax(eac):
    d = np.random.default_rng(76).standard_normal((50, 3)).astype(np.float32)
    face, u, v = tcube.dir_to_cubemap_coord(torch.from_numpy(d), 8, eac=eac)
    jface, ju, jv = jcube.dir_to_cubemap_coord(jnp.asarray(d), 8, eac=eac)
    np.testing.assert_array_equal(face.numpy(), np.asarray(jface))
    close(u, ju, **TOL)
    close(v, jv, **TOL)
    back = tcube.cubemap_coord_to_dir(face, u, v, 8, eac=eac)
    close(back, jcube.cubemap_coord_to_dir(jface, ju, jv, 8, eac=eac), **TOL)
    unit_cube = d / np.abs(d).max(-1, keepdims=True)
    close(back, unit_cube, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["nearest", "linear"])
@pytest.mark.parametrize("eac", [True, False])
def test_cubemap_sample_matches_jax(mode, eac):
    rng = np.random.default_rng(77)
    cube = rng.standard_normal((6, 5, 5, 3)).astype(np.float32)
    d = rng.standard_normal((4, 9, 3)).astype(np.float32)
    close(tcube.cubemap_sample(torch.from_numpy(cube), torch.from_numpy(d), eac=eac, mode=mode),
          jcube.cubemap_sample(jnp.asarray(cube), jnp.asarray(d), eac=eac, mode=mode), **TOL)
    with pytest.raises(ValueError, match="mode"):
        tcube.cubemap_sample(torch.from_numpy(cube), torch.from_numpy(d), mode="cubic")
