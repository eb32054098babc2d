"""The port's scene loaders (``data/llff.py``, ``nsvf.py``, ``deepvoxels.py``,
``linemod.py``, ``blender.py`` and ``base.py::load_scene``) and
``core/rays.py::ndc_rays`` against the JAX package (CPU), on roots written
the way ``tests/test_data.py`` writes them: every array of a loaded scene
equal to the bit, and the NDC warp of random forward-facing rays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_projects_tpu.core.rays import ndc_rays as jax_ndc_rays
from nerf_projects_tpu.data import base as jbase
from nerf_projects_tpu.data import blender as jblender
from nerf_projects_tpu.data import deepvoxels as jdeepvoxels
from nerf_projects_tpu.data import linemod as jlinemod
from nerf_projects_tpu.data import llff as jllff
from nerf_projects_tpu.data import nsvf as jnsvf
from nerf_projects_tpu_torch.core.rays import ndc_rays
from nerf_projects_tpu_torch.data import base, blender, deepvoxels, linemod, llff, nsvf
from tests.test_data import blender_root, dv_root, linemod_root, llff_root, nsvf_root  # noqa: F401

LOADERS = {
    "blender": (blender.load_blender, jblender.load_blender),
    "llff": (llff.load_llff, jllff.load_llff),
    "nsvf": (nsvf.load_nsvf, jnsvf.load_nsvf),
    "deepvoxels": (deepvoxels.load_deepvoxels, jdeepvoxels.load_deepvoxels),
    "linemod": (linemod.load_linemod, jlinemod.load_linemod),
}
ROOTS = {"blender": "blender_root", "llff": "llff_root", "nsvf": "nsvf_root", "deepvoxels": "dv_root",
         "linemod": "linemod_root"}

CASES = [
    ("blender", "train", {}),
    ("blender", "test", {"half_res": True, "testskip": 2}),
    ("llff", "train", {"factor": 1}),
    ("llff", "test", {"factor": 1}),
    ("llff", "train", {"factor": 2}),           # cv2's INTER_AREA downscale
    ("llff", "train", {"factor": 1, "spherify": True}),
    ("llff", "train", {"factor": 1, "ndc": False}),
    ("llff", "test", {"factor": 1, "llffhold": 0}),
    ("nsvf", "train", {}),
    ("nsvf", "test", {"scale": 0.5, "white_bkgd": False}),
    ("deepvoxels", "train", {}),
    ("deepvoxels", "test", {"testskip": 2}),
    ("linemod", "train", {}),
    ("linemod", "test", {"half_res": True}),
]


def assert_same_scene(got, want):
    for name in ("images", "poses", "intrinsics"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("render_poses", "bbox"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.near, got.far, got.ndc, got.white_bkgd) == (want.near, want.far, want.ndc, want.white_bkgd)
    assert (got.height, got.width, got.focal) == (want.height, want.width, want.focal)
    assert set(got.meta) == set(want.meta)
    for k, v in want.meta.items():
        np.testing.assert_array_equal(np.asarray(got.meta[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("kind,split,kwargs", CASES, ids=lambda c: str(c))
def test_loader_matches_jax(kind, split, kwargs, request):
    """The loader itself and ``load_scene``'s dispatch to it load the
    same scene as the JAX package's."""
    root = request.getfixturevalue(ROOTS[kind])
    assert base.detect_dataset_type(root) == jbase.detect_dataset_type(root) == kind
    load, jload = LOADERS[kind]
    want = jload(root, split, **kwargs)
    assert_same_scene(load(root, split, **kwargs), want)
    assert_same_scene(base.load_scene(root, split, **kwargs), jbase.load_scene(root, split, **kwargs))


def test_load_scene_raises_as_jax_on_an_unknown_root(tmp_path):
    with pytest.raises(ValueError, match="cannot detect"):
        base.load_scene(str(tmp_path))
    with pytest.raises(ValueError, match="cannot detect"):
        jbase.load_scene(str(tmp_path))


def forward_facing_rays(seed: int, n: int = 4096):
    """Origins near the camera plane z = 0, directions looking down -z
    (as an LLFF scene's recentred cameras)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.6, 0.6, (n, 2)), -rng.uniform(0.5, 1.5, (n, 1))], -1).astype(np.float32)
    return o, d


@pytest.mark.parametrize("near", [1.0, 0.5])
def test_ndc_rays_matches_jax(near):
    o, d = forward_facing_rays(7)
    H, W, focal = 378, 504, 407.5
    want = jax_ndc_rays(H, W, focal, near, jnp.asarray(o), jnp.asarray(d))
    got = ndc_rays(H, W, focal, near, torch.from_numpy(o), torch.from_numpy(d))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (4096, 3) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
    # the warp's fixed points: the near plane maps to NDC z = -1
    assert np.allclose(got[0][:, 2].numpy(), -1.0, atol=1e-6)
