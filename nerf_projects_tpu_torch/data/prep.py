"""Dataset preparation tooling: COLMAP runner, NSVF split management,
Record3D conversion, and metrics extraction (port of
``nerf_projects_tpu/data/prep.py``; host-side, cv2, scipy and tensorboard
imported at the call).

Parity targets (svox2/opt/scripts/ + svox2/opt/extract_metrics.py):
  * run_colmap.py:186-273 — the colmap subprocess pipeline
    (feature_extractor -> exhaustive/sequential matcher -> mapper
    [-> image_undistorter]) with the reference's flag set, plus image
    resizing and known-intrinsics handling;
  * create_split.py / unsplit.py — NSVF 0_/1_ prefix (un)splitting over
    the pose/rgb/images/feature/depths sibling directories;
  * proc_record3d.py — Record3D capture (metadata.json + side-by-side
    mp4) -> rgb/ + pose/ + intrinsics.txt NSVF layout;
  * extract_metrics.py — collect final metrics from checkpoint dirs
    into one CSV (ours reads MetricsLogger logs and test_psnr.txt; the
    reference reads TensorBoard event files, which we also try when the
    tensorboard package is importable).

All functions are library-first (CLI in cli/data_prep.py) and testable
without a real colmap binary (`colmap_bin` injection).
"""
from __future__ import annotations

import csv
import glob
import json
import os
import os.path as osp
import subprocess
from typing import Dict, List, NamedTuple, Optional

import numpy as np

IMAGE_EXTS = [".png", ".jpg", ".jpeg", ".gif", ".tif", ".tiff", ".bmp"]
DEPTH_EXTS = [".exr", ".pfm", ".png", ".npy"]

# (dir-name prefix, valid extensions) — create_split.py:33-41
SPLIT_DIR_PREFIXES = [
    ("pose", [".txt"]),
    ("poses", [".txt"]),
    ("feature", [".npz"]),
    ("rgb", IMAGE_EXTS),
    ("images", IMAGE_EXTS),
    ("image", IMAGE_EXTS),
    ("c2w", IMAGE_EXTS),
    ("depths", DEPTH_EXTS),
]


def _list_split_dirs(base: str):
    all_dirs = [x for x in os.listdir(base) if osp.isdir(osp.join(base, x))]
    dirs, ref_idx = [], 0
    for prefix, exts in SPLIT_DIR_PREFIXES:
        for d in all_dirs:
            if d.startswith(prefix):
                if d == "pose":
                    ref_idx = len(dirs)
                dirs.append((osp.join(base, d), exts))
    return dirs, ref_idx


def create_split(root_dir: str, *, every: int = 16, dry_run: bool = False,
                 randomize: bool = False, seed: int = 0) -> List[tuple]:
    """Rename dataset files with NSVF split prefixes: every `every`-th
    reference file becomes test (1_), the rest train (0_)
    (create_split.py). Returns the (old, new) rename list."""
    dirs, ref_idx = _list_split_dirs(root_dir)
    if not dirs:
        return []
    ref_dir, ref_exts = dirs[ref_idx]
    base_files = [
        osp.splitext(x)[0] for x in sorted(os.listdir(ref_dir))
        if osp.splitext(x)[1].lower() in ref_exts
    ]
    if randomize:
        import random

        random.Random(seed).shuffle(base_files)
    mapping = {
        x: f"{int(i % every == 0)}_" + x for i, x in enumerate(base_files)
    }
    renames = []
    for dirname, exts in dirs:
        for filename in sorted(os.listdir(dirname)):
            full = osp.join(dirname, filename)
            if filename.startswith(("0_", "1_")) or not osp.isfile(full):
                continue
            base, ext = osp.splitext(filename)
            if ext.lower() not in exts or base not in mapping:
                continue
            new = osp.join(dirname, mapping[base] + ext)
            renames.append((full, new))
            if not dry_run:
                os.rename(full, new)
    return renames


def unsplit(root_dir: str, *, dry_run: bool = False) -> List[tuple]:
    """Remove NSVF 0_/1_ split prefixes (unsplit.py)."""
    dirs, _ = _list_split_dirs(root_dir)
    renames = []
    for dirname, exts in dirs:
        for filename in sorted(os.listdir(dirname)):
            full = osp.join(dirname, filename)
            if not osp.isfile(full):
                continue
            base, ext = osp.splitext(filename)
            if ext.lower() not in exts:
                continue
            if not (base.startswith("0_") or base.startswith("1_")):
                continue
            new = osp.join(dirname, "_".join(base.split("_")[1:]) + ext)
            renames.append((full, new))
            if not dry_run:
                os.rename(full, new)
    return renames


# ---------------------------------------------------------------------------
# COLMAP runner
# ---------------------------------------------------------------------------

class ColmapRunResult(NamedTuple):
    commands: List[List[str]]
    sparse_dir: str


def resize_images(src_dir: str, dst_dir: str, *, max_width: int = 1280,
                  max_height: int = 768) -> int:
    """Area-downscale source images into dst_dir (run_colmap.py:157-183,
    cv2.INTER_AREA — same resampling the reference uses in place of
    ImageMagick)."""
    import cv2

    os.makedirs(dst_dir, exist_ok=True)
    files = sorted(
        p for p in glob.glob(osp.join(src_dir, "*"))
        if osp.splitext(p)[1].lower() in IMAGE_EXTS
    )
    n = 0
    for p in files:
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            continue
        h, w = img.shape[:2]
        factor = max(w / max_width, h / max_height, 1.0)
        if factor > 1.0:
            img = cv2.resize(
                img, (int(w / factor), int(h / factor)),
                interpolation=cv2.INTER_AREA,
            )
        import pathlib

        cv2.imwrite(str(pathlib.Path(dst_dir) / osp.basename(p)), img)
        n += 1
    return n


def run_colmap(
    root: str,
    *,
    image_dir: str = "images_resized",
    colmap_bin: str = "colmap",
    noradial: bool = True,
    known_intrin: bool = False,
    fix_intrin: bool = False,
    sequential: bool = False,
    max_num_matches: int = 132768,
    run: bool = True,
) -> ColmapRunResult:
    """The reference COLMAP pipeline (run_colmap.py:186-273):
    feature_extractor -> matcher -> mapper, with the reference's SIFT /
    matching parameters, single-camera model, and optional known
    intrinsics from <root>/intrinsics.txt. `run=False` returns the
    command list without executing (also used by tests with a mock
    binary)."""
    db = osp.join(root, "database.db")
    sparse = osp.join(root, "sparse")
    os.makedirs(sparse, exist_ok=True)
    img_path = osp.join(root, image_dir)

    extractor = [
        colmap_bin, "feature_extractor",
        f"--database_path={db}",
        f"--image_path={img_path}",
        "--ImageReader.single_camera=1",
        "--ImageReader.default_focal_length_factor=0.69388",
        "--SiftExtraction.peak_threshold=0.004",
        "--SiftExtraction.max_num_features=8192",
        "--SiftExtraction.edge_threshold=16",
        "--ImageReader.camera_model="
        + ("SIMPLE_PINHOLE" if noradial else "SIMPLE_RADIAL"),
    ]
    if known_intrin:
        intrin_path = osp.join(root, "intrinsics.txt")
        if osp.isfile(intrin_path):
            intrins = np.loadtxt(intrin_path)
            focal = (intrins[0, 0] + intrins[1, 1]) * 0.5
            cx, cy = intrins[0, 2], intrins[1, 2]
            params = f"{focal:.10f},{cx:.10f},{cy:.10f}"
            if not noradial:
                params += ",0.0"
            extractor.append(f"--ImageReader.camera_params={params}")
        else:
            known_intrin = False

    if sequential:
        matcher = [
            colmap_bin, "sequential_matcher",
            f"--database_path={db}",
            "--SiftMatching.multiple_models=0",
            f"--SiftMatching.max_num_matches={max_num_matches}",
            "--SequentialMatching.overlap=75",
            "--SequentialMatching.quadratic_overlap=0",
        ]
    else:
        matcher = [
            colmap_bin, "exhaustive_matcher",
            f"--database_path={db}",
            "--SiftMatching.multiple_models=0",
            "--SiftMatching.max_ratio=0.8",
            "--SiftMatching.max_error=4.0",
            "--SiftMatching.max_distance=0.7",
            f"--SiftMatching.max_num_matches={max_num_matches}",
        ]

    mapper = [
        colmap_bin, "mapper",
        f"--database_path={db}",
        f"--image_path={img_path}",
        f"--output_path={sparse}",
    ]
    if known_intrin and fix_intrin:
        mapper += [
            "--Mapper.ba_refine_focal_length=0",
            "--Mapper.ba_refine_principal_point=0",
            "--Mapper.ba_refine_extra_params=0",
        ]

    commands = [extractor, matcher, mapper]
    if run:
        for cmd in commands:
            subprocess.run(cmd, check=True)
    return ColmapRunResult(commands=commands, sparse_dir=osp.join(sparse, "0"))


def preprocess_colmap(
    root: str,
    *,
    colmap_bin: str = "colmap",
    max_width: int = 1280,
    max_height: int = 768,
    every: int = 16,
    scale: float = 1.0,
    run: bool = True,
) -> Dict[str, object]:
    """Full preprocess (run_colmap.py preprocess:354-381): resize ->
    colmap -> NSVF layout (pose/ + intrinsics.txt via
    data/colmap.colmap_to_nsvf) -> create_split."""
    from nerf_projects_tpu_torch.data.colmap import colmap_to_nsvf

    n = resize_images(
        osp.join(root, "raw") if osp.isdir(osp.join(root, "raw"))
        else osp.join(root, "images"),
        osp.join(root, "images_resized"),
        max_width=max_width, max_height=max_height,
    )
    result = run_colmap(root, colmap_bin=colmap_bin, run=run)
    out: Dict[str, object] = {"n_images": n, "commands": result.commands}
    if run and osp.isdir(result.sparse_dir):
        colmap_to_nsvf(result.sparse_dir, root, scale=scale)
        out["renames"] = create_split(root, every=every)
    return out


# ---------------------------------------------------------------------------
# Record3D
# ---------------------------------------------------------------------------

def proc_record3d(data_dir: str, *, every: int = 15, factor: int = 2) -> int:
    """Record3D capture -> NSVF layout (proc_record3d.py).

    Expects metadata.json (K row-major + per-frame quaternion|translation
    poses) and one mp4 whose frames are side-by-side depth|rgb; writes
    rgb/%05d.png, pose/%05d.txt, intrinsics.txt. Returns frame count."""
    import cv2

    video_files = glob.glob(osp.join(data_dir, "*.mp4"))
    if not video_files:
        raise FileNotFoundError(f"no .mp4 in {data_dir}")
    meta = json.load(open(osp.join(data_dir, "metadata.json")))

    K3 = np.array(meta["K"]).reshape(3, 3)
    K = np.eye(4)
    K[:3, :3] = K3.T / factor
    np.savetxt(osp.join(data_dir, "intrinsics.txt"), K)

    poses = np.array(meta["poses"])  # [N, 7] = qx qy qz qw | tx ty tz
    t = poses[:, 4:]
    q = poses[:, :4]
    from scipy.spatial.transform import Rotation

    R = Rotation.from_quat(q).as_matrix()
    t = t - np.mean(t, axis=0)
    all_poses = np.zeros((len(q), 4, 4))
    all_poses[:, -1, -1] = 1
    all_poses[:, :3] = np.concatenate([R, t[:, :, None]], axis=2)
    all_poses = all_poses @ np.diag([1, -1, -1, 1])

    video = cv2.VideoCapture(video_files[0])
    w2 = int(video.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(video.get(cv2.CAP_PROP_FRAME_HEIGHT))
    w = w2 // 2
    length = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
    os.makedirs(osp.join(data_dir, "pose"), exist_ok=True)
    os.makedirs(osp.join(data_dir, "rgb"), exist_ok=True)
    idx = 0
    for i in range(0, length, every):
        video.set(cv2.CAP_PROP_POS_FRAMES, i)
        ret, frame = video.read()
        if not ret or frame is None or i >= len(all_poses):
            continue
        frame = frame[:, w:]  # right half = rgb
        if factor != 1:
            frame = cv2.resize(
                frame, (w // factor, h // factor),
                interpolation=cv2.INTER_AREA,
            )
        cv2.imwrite(osp.join(data_dir, "rgb", f"{idx:05d}.png"), frame)
        np.savetxt(osp.join(data_dir, "pose", f"{idx:05d}.txt"), all_poses[i])
        idx += 1
    return idx


# ---------------------------------------------------------------------------
# extract_metrics
# ---------------------------------------------------------------------------

def extract_metrics(ckpt_root: str, out_csv: Optional[str] = None) -> List[dict]:
    """Final metrics from every checkpoint dir under ckpt_root ->
    metrics_extracted.csv (extract_metrics.py). Sources, in priority
    order: metrics_log.json evaluation entries, test_psnr.txt,
    training_log.jsonl tail, TensorBoard event files when readable."""
    rows: List[dict] = []
    dirs = [ckpt_root] if _is_ckpt_dir(ckpt_root) else sorted(
        d for d in glob.glob(osp.join(ckpt_root, "*")) if _is_ckpt_dir(d)
    )
    for d in dirs:
        row: Dict[str, object] = {"scene": osp.basename(d.rstrip("/"))}
        from nerf_projects_tpu_torch.obs.analysis import (
            load_metrics_log,
            load_training_log,
        )

        evals = [
            e for e in load_metrics_log(d)
            if e.get("phase") in ("evaluation", "octree_evaluation")
        ]
        if evals:
            for k in ("psnr", "ssim", "lpips", "fps"):
                if evals[-1]["metrics"].get(k) is not None:
                    row[f"test_{k}"] = evals[-1]["metrics"][k]
        tp = osp.join(d, "test_psnr.txt")
        if osp.exists(tp) and "test_psnr" not in row:
            row["test_psnr"] = float(open(tp).read().strip())
        train = load_training_log(d)
        if train:
            row["final_train_psnr"] = train[-1].get("psnr")
            row["steps"] = train[-1].get("step")
        tm = osp.join(d, "time_mins.txt")
        if osp.exists(tm):
            row["time_mins"] = float(open(tm).read().strip())
        row.update(_tb_final_scalars(d))
        rows.append(row)

    if rows:
        out_csv = out_csv or osp.join(ckpt_root, "metrics_extracted.csv")
        keys = sorted({k for r in rows for k in r})
        with open(out_csv, "w", newline="") as f:
            wr = csv.DictWriter(f, fieldnames=keys)
            wr.writeheader()
            wr.writerows(rows)
    return rows


def _is_ckpt_dir(d: str) -> bool:
    return osp.isdir(d) and any(
        osp.exists(osp.join(d, f))
        for f in ("metrics_log.json", "test_psnr.txt", "training_log.jsonl")
    ) or (osp.isdir(d) and bool(glob.glob(osp.join(d, "events.out.tfevents.*"))))


def _tb_final_scalars(d: str) -> Dict[str, float]:
    if not glob.glob(osp.join(d, "events.out.tfevents.*")):
        return {}
    try:
        from tensorboard.backend.event_processing import event_accumulator
    except ImportError:
        return {}
    try:
        ea = event_accumulator.EventAccumulator(d)
        ea.Reload()
        out = {}
        for tag in ea.Tags().get("scalars", []):
            events = ea.Scalars(tag)
            if events:
                out["tb_" + tag.replace("/", "_")] = events[-1].value
        return out
    except Exception:
        return {}
