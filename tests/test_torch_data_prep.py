"""The port's data tools against the JAX package's, on the same seeded
inputs: the COLMAP readers and converters (``data/colmap.py``), the ingp
converter, ``minify`` and the timings parser (``data/converters.py``), the
NSVF splits, the COLMAP runner (a mock binary: neither machine has
COLMAP), Record3D and ``extract_metrics`` (``data/prep.py``), the
``data_prep`` and ``view_data`` CLIs and the CO3D loader (``data/co3d.py``,
which has no JAX test of its own).

Each case runs both packages on copies of one input and compares what they
write: the files (poses, intrinsics, npy, PNG, CSV, OBJ) byte for byte,
the returned values and the rename lists (relative to each copy) equal.
The arithmetic is the same numpy in both, so equality holds; CO3D's
float32 poses are held to 1e-6 relative. JAX's view_data figure is built
but not drawn (``pixels_off``); the port's PNG must be non-empty.
"""
import filecmp
import gzip
import json
import os
import os.path as osp
import shutil
import stat
import struct

import numpy as np
import pytest

from nerf_projects_tpu_torch.data import colmap, converters, prep
from test_torch_analysis import pixels_off

RTOL = 1e-6


def jax_modules():
    from nerf_projects_tpu.data import colmap as jcolmap
    from nerf_projects_tpu.data import converters as jconverters
    from nerf_projects_tpu.data import prep as jprep

    return jcolmap, jconverters, jprep


def write_model(sparse_dir, model_id=1, n_images=3, n_points=50, seed=0):
    """tests/test_colmap.py's synthetic binary model, with the camera model
    a parameter: 1 PINHOLE (fx, fy, cx, cy), 2 SIMPLE_RADIAL (f, cx, cy, k)."""
    os.makedirs(sparse_dir, exist_ok=True)
    params = {1: (50.0, 52.0, 32.0, 24.0), 2: (50.0, 32.0, 24.0, 0.01)}[model_id]
    with open(osp.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, model_id, 64, 48))
        f.write(struct.pack("<4d", *params))
    rng = np.random.default_rng(seed)
    with open(osp.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in range(n_images):
            q = rng.standard_normal(4)
            q /= np.linalg.norm(q)
            t = rng.standard_normal(3) * 0.1 + [0, 0, 4]
            f.write(struct.pack("<idddddddi", i + 1, *q, *t, 1))
            f.write(f"img_{i:03d}.jpg".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            for j in range(2):
                f.write(struct.pack("<ddQ", 1.0 + j, 2.0, 7 + i))
    with open(osp.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_points))
        for j in range(n_points):
            xyz = rng.standard_normal(3) * 0.5
            f.write(struct.pack("<QdddBBBd", j, *xyz, 100, 120 + j % 7, 140, 0.5))
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 1, 0))
    return sparse_dir


def same_tree(a, b):
    """Every file under a and b, byte for byte, and the same names."""
    names_a = sorted(osp.relpath(osp.join(r, f), a) for r, _, fs in os.walk(a) for f in fs)
    names_b = sorted(osp.relpath(osp.join(r, f), b) for r, _, fs in os.walk(b) for f in fs)
    assert names_a == names_b
    for n in names_a:
        assert filecmp.cmp(osp.join(a, n), osp.join(b, n), shallow=False), n
    return names_a


def two_copies(tmp_path, make):
    """make(root) builds an input; returns (jax copy, port copy) of it,
    each under a directory of the same name."""
    make(str(tmp_path / "input" / "scene"))
    for side in ("jax", "port"):
        shutil.copytree(tmp_path / "input", tmp_path / side)
    return str(tmp_path / "jax" / "scene"), str(tmp_path / "port" / "scene")


def rel(renames, root):
    return [(osp.relpath(a, root), osp.relpath(b, root)) for a, b in renames]


# -- COLMAP (tests/test_colmap.py) -----------------------------------------


@pytest.mark.parametrize("model_id,model", [(1, "PINHOLE"), (2, "SIMPLE_RADIAL")])
def test_readers_match_jax(tmp_path, model_id, model):
    jcolmap, _, _ = jax_modules()
    sparse = write_model(str(tmp_path / "sparse"), model_id)
    cams = colmap.read_cameras_binary(osp.join(sparse, "cameras.bin"))
    want_cams = jcolmap.read_cameras_binary(osp.join(sparse, "cameras.bin"))
    assert cams[1].model == want_cams[1].model == model and cams[1].width == 64
    assert cams[1][:4] == want_cams[1][:4]
    np.testing.assert_array_equal(cams[1].params, want_cams[1].params)
    imgs = colmap.read_images_binary(osp.join(sparse, "images.bin"))
    want_imgs = jcolmap.read_images_binary(osp.join(sparse, "images.bin"))
    assert sorted(imgs) == sorted(want_imgs) == [1, 2, 3]
    for k in imgs:
        for name, got, want in zip(imgs[k]._fields, imgs[k], want_imgs[k]):
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert imgs[1].name == "img_000.jpg" and (imgs[2].point3d_ids == 8).all()
    xyz, rgb = colmap.read_points3d_binary(osp.join(sparse, "points3D.bin"))
    want_xyz, want_rgb = jcolmap.read_points3d_binary(osp.join(sparse, "points3D.bin"))
    np.testing.assert_array_equal(xyz, want_xyz)
    np.testing.assert_array_equal(rgb, want_rgb)
    assert xyz.shape == (50, 3) and rgb.dtype == np.uint8 and (rgb[0] == [100, 120, 140]).all()


def test_rotation_and_c2w_match_jax(tmp_path):
    """qvec2rotmat on seeded unit quaternions (orthonormal, det 1) and
    colmap_c2w inverting each image's world-to-camera transform."""
    jcolmap, _, _ = jax_modules()
    q = np.random.default_rng(1).standard_normal((8, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    for qi in q:
        R = colmap.qvec2rotmat(qi)
        np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(qi))
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-10)
        assert np.linalg.det(R) == pytest.approx(1.0)
    sparse = write_model(str(tmp_path / "sparse"))
    for img in colmap.read_images_binary(osp.join(sparse, "images.bin")).values():
        c2w = colmap.colmap_c2w(img)
        np.testing.assert_array_equal(c2w, jcolmap.colmap_c2w(img))
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = colmap.qvec2rotmat(img.qvec), img.tvec
        np.testing.assert_allclose(c2w @ w2c, np.eye(4), atol=1e-10)


@pytest.mark.parametrize("model_id", [1, 2])
def test_colmap_to_nsvf_matches_jax(tmp_path, model_id):
    jcolmap, _, _ = jax_modules()
    sparse = write_model(str(tmp_path / "sparse"), model_id)
    jcolmap.colmap_to_nsvf(sparse, str(tmp_path / "jax"), scale=0.5)
    assert colmap.colmap_to_nsvf(sparse, str(tmp_path / "port"), scale=0.5) == str(tmp_path / "port")
    names = same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert names == ["bbox.txt", "intrinsics.txt", "pose/img_000.txt", "pose/img_001.txt", "pose/img_002.txt"]
    pose = np.loadtxt(tmp_path / "port" / "pose" / "img_000.txt")
    assert pose.shape == (4, 4)
    np.testing.assert_allclose(pose[3], [0, 0, 0, 1])


def test_colmap_to_poses_bounds_matches_jax(tmp_path):
    jcolmap, _, _ = jax_modules()
    sparse = write_model(str(tmp_path / "sparse"))
    want = jcolmap.colmap_to_poses_bounds(sparse, str(tmp_path / "jax.npy"))
    got = colmap.colmap_to_poses_bounds(sparse, str(tmp_path / "port.npy"))
    np.testing.assert_array_equal(got, want)
    assert filecmp.cmp(tmp_path / "jax.npy", tmp_path / "port.npy", shallow=False)
    assert got.shape == (3, 17) and (got[:, 15] < got[:, 16]).all()
    assert got[0, :15].reshape(3, 5)[2, 4] == 50.0


# -- converters (tests/test_converters.py) ---------------------------------


@pytest.mark.parametrize("intrinsics", ["camera_angle_x", "fl_x"])
def test_ingp_to_nsvf_matches_jax(tmp_path, intrinsics):
    _, jconverters, _ = jax_modules()
    rng = np.random.default_rng(2)
    meta = {"w": 64, "h": 48, "aabb_scale": 2,
            "frames": [{"file_path": f"images/{i:03d}.png", "transform_matrix": rng.standard_normal((4, 4)).tolist()}
                       for i in range(3)]}
    meta.update({"camera_angle_x": 0.8} if intrinsics == "camera_angle_x"
                else {"fl_x": 70.0, "fl_y": 71.5, "cx": 31.0, "cy": 25.0})
    p = tmp_path / "transforms.json"
    p.write_text(json.dumps(meta))
    jconverters.ingp_to_nsvf(str(p), str(tmp_path / "jax"), scale=2.0)
    converters.ingp_to_nsvf(str(p), str(tmp_path / "port"), scale=2.0)
    assert len(same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))) == 5
    K = np.loadtxt(tmp_path / "port" / "intrinsics.txt")
    assert K[0, 0] == pytest.approx(0.5 * 64 / np.tan(0.4) if intrinsics == "camera_angle_x" else 70.0)
    assert np.loadtxt(tmp_path / "port" / "bbox.txt")[3] == 4.0


def test_minify_matches_jax(tmp_path):
    import imageio.v2 as imageio

    _, jconverters, _ = jax_modules()

    def make(root):
        rng = np.random.default_rng(0)
        os.makedirs(osp.join(root, "images"))
        for i in range(2):
            imageio.imwrite(osp.join(root, "images", f"i{i}.png"),
                            (rng.uniform(size=(32, 48, 3)) * 255).astype(np.uint8))

    jroot, proot = two_copies(tmp_path, make)
    jconverters.minify(jroot, factors=(2, 4))
    assert converters.minify(proot, factors=(2, 4)) == proot
    same_tree(jroot, proot)
    assert imageio.imread(osp.join(proot, "images_4", "i0.png")).shape[:2] == (8, 12)


@pytest.mark.parametrize("lines", [["100 2026-01-01T00:00:00", "200 2026-01-01T00:00:10", "bad line here"],
                                   ["5 2026-01-01T00:00:00"]])
def test_parse_timings_matches_jax(tmp_path, lines):
    _, jconverters, _ = jax_modules()
    p = tmp_path / "timings.txt"
    p.write_text("\n".join(lines) + "\n")
    got = converters.parse_timings(str(p))
    assert got == jconverters.parse_timings(str(p))
    if len(lines) > 1:
        assert got["steps"] == 100 and got["steps_per_sec"] == pytest.approx(10.0)


# -- prep (tests/test_data_prep.py) ----------------------------------------


def make_nsvf_dirs(root, n=8):
    """tests/test_data_prep.py's NSVF layout, plus an images/ sibling and
    a file of another extension the split must leave alone."""
    for d in ("pose", "rgb", "images_4"):
        os.makedirs(osp.join(root, d))
    for i in range(n):
        np.savetxt(osp.join(root, "pose", f"{i:04d}.txt"), np.eye(4))
        open(osp.join(root, "rgb", f"{i:04d}.png"), "wb").write(b"png")
        open(osp.join(root, "images_4", f"{i:04d}.jpg"), "wb").write(b"jpg")
    open(osp.join(root, "rgb", "notes.md"), "w").write("x")
    return root


@pytest.mark.parametrize("randomize", [False, True])
def test_split_then_unsplit_matches_jax(tmp_path, randomize):
    _, _, jprep = jax_modules()
    jroot, proot = two_copies(tmp_path, make_nsvf_dirs)
    before = sorted(os.listdir(osp.join(proot, "pose")))
    dry = prep.create_split(proot, every=4, dry_run=True, randomize=randomize)
    assert rel(dry, proot) == rel(jprep.create_split(jroot, every=4, dry_run=True, randomize=randomize), jroot)
    assert sorted(os.listdir(osp.join(proot, "pose"))) == before
    got = prep.create_split(proot, every=4, randomize=randomize)
    assert rel(got, proot) == rel(jprep.create_split(jroot, every=4, randomize=randomize), jroot)
    # images_4 matches both the "images" and the "image" prefix: a dry run
    # lists its files twice, a real run renames them once (as JAX's does)
    assert len(got) == 24 and len(dry) == 32
    names = sorted(os.listdir(osp.join(proot, "pose")))
    assert len([n for n in names if n.startswith("1_")]) == 2 and len([n for n in names if n.startswith("0_")]) == 6
    same_tree(jroot, proot)
    assert prep.create_split(proot, every=4) == []
    assert rel(prep.unsplit(proot), proot) == rel(jprep.unsplit(jroot), jroot)
    assert sorted(os.listdir(osp.join(proot, "pose"))) == before
    same_tree(jroot, proot)


def colmap_commands(res, root):
    return [[a.replace(root, "ROOT") for a in cmd] for cmd in res.commands], res.sparse_dir.replace(root, "ROOT")


@pytest.mark.parametrize("kw", [{}, dict(known_intrin=True, fix_intrin=True), dict(sequential=True, noradial=False),
                                dict(known_intrin=True, noradial=False, image_dir="imgs")])
def test_run_colmap_commands_match_jax(tmp_path, kw):
    _, _, jprep = jax_modules()

    def make(root):
        os.makedirs(root)
        np.savetxt(osp.join(root, "intrinsics.txt"), np.array([[100.0, 0, 32], [0, 102.0, 24], [0, 0, 1]]))

    jroot, proot = two_copies(tmp_path, make)
    got = prep.run_colmap(proot, colmap_bin="colmap-x", run=False, **kw)
    assert colmap_commands(got, proot) == colmap_commands(jprep.run_colmap(jroot, colmap_bin="colmap-x", run=False,
                                                                           **kw), jroot)
    ext, match, mapper = got.commands
    assert ext[1] == "feature_extractor" and "--ImageReader.single_camera=1" in ext
    assert match[1] == ("sequential_matcher" if kw.get("sequential") else "exhaustive_matcher")
    if kw.get("fix_intrin"):
        f, cx, cy = [float(x) for x in [a for a in ext if "camera_params" in a][0].split("=")[1].split(",")]
        assert (f, cx, cy) == (101.0, 32.0, 24.0) and "--Mapper.ba_refine_focal_length=0" in mapper


def mock_colmap(path, log, model_dir):
    """A stand-in colmap: logs its subcommand; ``mapper`` copies a binary
    model into <output_path>/0 as the real mapper writes one."""
    path.write_text("#!/bin/sh\n"
                    f'echo "$1" >> {log}\n'
                    'if [ "$1" = mapper ]; then\n'
                    '  for a in "$@"; do case "$a" in --output_path=*) out="${a#--output_path=}";; esac; done\n'
                    f'  mkdir -p "$out" && cp -r {model_dir} "$out/0"\n'
                    "fi\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_preprocess_colmap_with_a_mock_binary_matches_jax(tmp_path):
    """resize_images (cv2) -> run_colmap through the mock -> colmap_to_nsvf
    -> create_split, on both packages."""
    import cv2

    _, _, jprep = jax_modules()
    model = write_model(str(tmp_path / "model"))

    def make(root):
        rng = np.random.default_rng(3)
        os.makedirs(osp.join(root, "images"))
        for i in range(3):
            cv2.imwrite(osp.join(root, "images", f"img_{i:03d}.jpg"),
                        (rng.uniform(size=(40, 90, 3)) * 255).astype(np.uint8))

    jroot, proot = two_copies(tmp_path, make)
    outs = []
    for side, fn, root in (("jax", jprep.preprocess_colmap, jroot), ("port", prep.preprocess_colmap, proot)):
        binary = mock_colmap(tmp_path / f"colmap_{side}", tmp_path / f"calls_{side}.log", model)
        out = fn(root, colmap_bin=binary, max_width=45, max_height=30, every=2)
        outs.append((out["n_images"], rel(out["renames"], root),
                     [[a.replace(root, "ROOT").replace(binary, "COLMAP") for a in c] for c in out["commands"]]))
    assert outs[0] == outs[1] and outs[1][0] == 3
    assert (tmp_path / "calls_port.log").read_text().split() == ["feature_extractor", "exhaustive_matcher", "mapper"]
    same_tree(jroot, proot)
    assert cv2.imread(osp.join(proot, "images_resized", "1_img_000.jpg")).shape == (20, 45, 3)  # split too
    assert sorted(os.listdir(osp.join(proot, "pose"))) == ["0_img_001.txt", "1_img_000.txt", "1_img_002.txt"]


def test_record3d_matches_jax(tmp_path):
    import cv2

    _, _, jprep = jax_modules()
    W, H, N = 32, 16, 6

    def make(root):
        os.makedirs(root)
        vw = cv2.VideoWriter(osp.join(root, "cap.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (2 * W, H))
        for i in range(N):
            frame = np.zeros((H, 2 * W, 3), np.uint8)
            frame[:, W:] = (i * 30) % 255
            vw.write(frame)
        vw.release()
        rng = np.random.default_rng(0)
        q = rng.standard_normal((N, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        meta = {"K": [50.0, 0, 16, 0, 50.0, 8, 0, 0, 1],
                "poses": np.concatenate([q, rng.standard_normal((N, 3))], axis=-1).tolist()}
        json.dump(meta, open(osp.join(root, "metadata.json"), "w"))

    jroot, proot = two_copies(tmp_path, make)
    assert prep.proc_record3d(proot, every=2, factor=2) == jprep.proc_record3d(jroot, every=2, factor=2) == 3
    names = same_tree(jroot, proot)
    assert [n for n in names if n.startswith("rgb/")] == [f"rgb/{i:05d}.png" for i in range(3)]
    assert np.loadtxt(osp.join(proot, "intrinsics.txt"))[0, 0] == pytest.approx(25.0)
    assert cv2.imread(osp.join(proot, "rgb", "00000.png")).shape == (8, 16, 3)
    with pytest.raises(FileNotFoundError):
        prep.proc_record3d(str(tmp_path))


def make_ckpt_dirs(base):
    """tests/test_data_prep.py's two evaluated scenes, plus one with only a
    training log and test_psnr.txt, written by the port's MetricsLogger."""
    from nerf_projects_tpu_torch.obs.json_logger import MetricsLogger

    for scene, psnr in [("lego", 34.4), ("ship", 29.6)]:
        d = osp.join(base, scene)
        MetricsLogger(d).log_evaluation_step(100, {"psnr": psnr, "ssim": 0.95})
        open(osp.join(d, "time_mins.txt"), "w").write("12.5\n")
    d = osp.join(base, "chair")
    os.makedirs(d)
    with open(osp.join(d, "training_log.jsonl"), "w") as f:
        for step in (10, 20):
            f.write(json.dumps({"step": step, "psnr": 20.0 + step / 10, "loss": 0.1}) + "\n")
    open(osp.join(d, "test_psnr.txt"), "w").write("27.25\n")
    os.makedirs(osp.join(base, "empty"))


def test_extract_metrics_matches_jax(tmp_path):
    _, _, jprep = jax_modules()
    jroot, proot = two_copies(tmp_path, make_ckpt_dirs)
    got = prep.extract_metrics(proot)
    assert got == jprep.extract_metrics(jroot)
    assert {r["scene"]: r.get("test_psnr") for r in got} == {"chair": 27.25, "lego": 34.4, "ship": 29.6}
    assert {r["scene"]: r.get("time_mins") for r in got}["ship"] == 12.5
    same_tree(jroot, proot)
    assert osp.exists(osp.join(proot, "metrics_extracted.csv"))


def test_data_prep_cli_matches_jax(tmp_path, capsys):
    from nerf_projects_tpu.cli.data_prep import main as jmain
    from nerf_projects_tpu_torch.cli.data_prep import main

    jroot, proot = two_copies(tmp_path, make_nsvf_dirs)
    outs = []
    for run, root in ((jmain, jroot), (main, proot)):
        run(["create_split", root, "--every", "4", "--dry_run"])
        run(["create_split", root, "--every", "4"])
        run(["run_colmap", root, "--dry_run", "--sequential"])
        run(["unsplit", root])
        outs.append(capsys.readouterr().out.replace(root, "ROOT"))
    assert outs[0] == outs[1]
    assert "(32 files — dry run)" in outs[1] and "(24 files)" in outs[1]
    assert "feature_extractor" in outs[1] and "sequential_matcher" in outs[1] and "mapper" in outs[1]
    same_tree(jroot, proot)


# -- view_data (tests/test_data_prep.py::TestViewData) ---------------------


def test_view_data_matches_jax(tmp_path):
    """A three-view Blender dataset with a sparse point cloud: the OBJ of
    frustums, box and points equal; the port's PNG non-empty."""
    import imageio.v2 as imageio

    from nerf_projects_tpu.cli.view_data import view_dataset as jview
    from nerf_projects_tpu_torch.cli.view_data import main

    def make(root):
        os.makedirs(osp.join(root, "train"))
        frames = []
        for i in range(3):
            imageio.imwrite(osp.join(root, "train", f"r_{i}.png"), np.zeros((8, 8, 4), np.uint8))
            c2w = np.eye(4)
            c2w[2, 3] = 4.0 + i
            frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
        json.dump({"camera_angle_x": 0.7, "frames": frames}, open(osp.join(root, "transforms_train.json"), "w"))
        write_model(osp.join(root, "sparse", "0"), n_points=30)

    jroot, proot = two_copies(tmp_path, make)
    with pixels_off():
        jview(jroot, "train", str(tmp_path / "jax_out"))
    main([proot, "--split", "train", "--out", str(tmp_path / "port_out")])
    assert filecmp.cmp(tmp_path / "jax_out" / "cameras.obj", tmp_path / "port_out" / "cameras.obj", shallow=False)
    content = (tmp_path / "port_out" / "cameras.obj").read_text()
    assert content.count("l ") > 20 and content.count("\np ") == 30
    assert os.path.getsize(tmp_path / "port_out" / "cameras.png") > 0


# -- CO3D (no JAX test) ----------------------------------------------------


def make_co3d(root, name="frame_annotations.jgz"):
    """Two sequences of 5 and 3 frames of 12x16 PNGs, seeded viewpoints in
    CO3D's NDC intrinsics convention, listed out of frame order."""
    import imageio.v2 as imageio

    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(7)
    anns = []
    for seq, n in (("seq_a", 5), ("seq_b", 3)):
        os.makedirs(osp.join(root, seq, "images"))
        for k in rng.permutation(n):
            path = osp.join(seq, "images", f"frame{k:03d}.png")
            imageio.imwrite(osp.join(root, path), (rng.uniform(size=(12, 16, 3)) * 255).astype(np.uint8))
            anns.append({"sequence_name": seq, "frame_number": int(k), "image": {"path": path},
                         "viewpoint": {"R": Rotation.from_rotvec(rng.standard_normal(3)).as_matrix().tolist(),
                                       "T": rng.standard_normal(3).tolist(),
                                       "focal_length": rng.uniform(1.5, 2.5, 2).tolist(),
                                       **({"principal_point": rng.uniform(-0.1, 0.1, 2).tolist()} if k % 2 else {})}})
    text = json.dumps(anns)
    if name.endswith("gz"):
        with gzip.open(osp.join(root, name), "wt") as f:
            f.write(text)
    else:
        open(osp.join(root, name), "w").write(text)


@pytest.mark.parametrize("name", ["frame_annotations.jgz", "frame_annotations.json.gz", "frame_annotations.json"])
def test_co3d_matches_jax(tmp_path, name):
    from nerf_projects_tpu.data.co3d import load_co3d as jload
    from nerf_projects_tpu_torch.data.co3d import load_co3d

    make_co3d(str(tmp_path), name)
    for split, kw in (("train", {}), ("test", {}), ("train", dict(sequence="seq_b", test_every=2)),
                      ("test", dict(sequence="seq_a", test_every=2, max_frames=4))):
        got, want = load_co3d(str(tmp_path), split, **kw), jload(str(tmp_path), split, **kw)
        np.testing.assert_array_equal(got.images, want.images)
        for field in ("poses", "intrinsics"):
            np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=RTOL, atol=1e-6)
        assert (got.near, got.far, got.white_bkgd, got.meta) == (want.near, want.far, want.white_bkgd, want.meta)
        assert got.images.shape[1:] == (12, 16, 3) and got.poses.dtype == np.float32
    assert load_co3d(str(tmp_path), "train").images.shape[0] == 4
    with pytest.raises(FileNotFoundError):
        load_co3d(str(tmp_path / "seq_a"))
