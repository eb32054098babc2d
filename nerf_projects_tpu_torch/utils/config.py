"""Config system: the reference's three flag/config styles, reproduced
(port of ``nerf_projects_tpu/utils/config.py``; PyYAML, which the card's
machine lacks, is imported where a YAML file is read or written).

  1. Vanilla-NeRF YAML configs (reference nerf/utils.py:8-209): defaults
     for all ~45 keys, load/save/validate, AttrDict dot access — so the
     reference's nerf/yaml/* files are consumable as-is.
  2. NeRF-SH flag set with YAML overlay rejecting unknown keys
     (plenoctree/nerf_sh/nerf/utils.py:61-244 `define_flags` /
     `update_flags` / `check_flags`).
  3. argparse + JSON overlay rejecting unknown keys
     (svox2/opt/util/config_util.py:130-140 `maybe_merge_config_file`).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional


class AttrDict(dict):
    """dict with attribute access, recursive (nerf notebook cell 6)."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = AttrDict(v) if isinstance(v, dict) else v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def create_default_config() -> Dict[str, Any]:
    """All default keys of the vanilla-NeRF config (nerf/utils.py:60-132)."""
    return {
        "expname": "nerf_experiment",
        "basedir": "./logs/",
        "datadir": "./data/llff/fern",
        "netdepth": 8,
        "netwidth": 256,
        "netdepth_fine": 8,
        "netwidth_fine": 256,
        "N_rand": 32 * 32 * 4,
        "lrate": 5e-4,
        "lrate_decay": 250,
        "chunk": 1024 * 32,
        "netchunk": 1024 * 64,
        "no_batching": False,
        "no_reload": False,
        "ft_path": None,
        "N_samples": 64,
        "N_importance": 0,
        "perturb": 1.0,
        "use_viewdirs": False,
        "i_embed": 0,
        "multires": 10,
        "multires_views": 4,
        "raw_noise_std": 0.0,
        "render_only": False,
        "render_test": False,
        "render_factor": 0,
        "precrop_iters": 0,
        "precrop_frac": 0.5,
        "dataset_type": "llff",
        "testskip": 8,
        "shape": "greek",
        "white_bkgd": False,
        "half_res": False,
        "factor": 8,
        "no_ndc": False,
        "lindisp": False,
        "spherify": False,
        "llffhold": 8,
        "i_print": 100,
        "i_img": 500,
        "i_weights": 10000,
        "i_testset": 50000,
        "i_video": 50000,
        # training length (notebook cell 21: N_iters = 200001)
        "N_iters": 200001,
    }


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def save_yaml(config: Dict[str, Any], path: str):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dict(config), f, default_flow_style=False)


def validate_config(config: Dict[str, Any]) -> bool:
    """Basic validity checks (nerf/utils.py:134-181 equivalent)."""
    required = ["expname", "basedir", "datadir", "dataset_type"]
    for k in required:
        if k not in config or config[k] in (None, ""):
            raise ValueError(f"config missing required key: {k}")
    if config.get("dataset_type") not in (
        "llff", "blender", "deepvoxels", "LINEMOD", "linemod", "nsvf", "auto",
    ):
        raise ValueError(f"unknown dataset_type {config['dataset_type']!r}")
    for k in ("N_samples", "N_rand", "netdepth", "netwidth"):
        if k in config and int(config[k]) <= 0:
            raise ValueError(f"{k} must be positive")
    return True


def load_or_create_config(path: Optional[str]) -> AttrDict:
    """Defaults overlaid with the YAML at `path` (nerf/utils.py:183-208).
    Unknown keys in the file are kept (the reference tolerates extras
    here, unlike the nerf_sh/svox2 loaders)."""
    config = create_default_config()
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"config file not found: {path}")
        config.update(load_yaml(path))
    validate_config(config)
    return AttrDict(config)


# ---------------------------------------------------------------------------
# Style 2: dataclass "flags" + YAML overlay with unknown-key rejection
# ---------------------------------------------------------------------------

def update_flags(flags, config_path: str):
    """Overlay YAML onto a dataclass/namespace, rejecting unknown keys
    (nerf_sh/nerf/utils.py:233-244)."""
    data = load_yaml(config_path)
    known = (
        set(f.name for f in dataclasses.fields(flags))
        if dataclasses.is_dataclass(flags)
        else set(vars(flags).keys())
    )
    for k in data:
        if k not in known:
            raise ValueError(f"unknown config key: {k}")
    for k, v in data.items():
        setattr(flags, k, v)
    return flags


def check_flags(flags, *, require_data: bool = True, n_devices: int = 1):
    """Invariant checks (nerf_sh/nerf/utils.py:247-253)."""
    if require_data and not getattr(flags, "data_dir", None):
        raise ValueError("data_dir must be set")
    if not getattr(flags, "train_dir", None):
        raise ValueError("train_dir must be set")
    bs = getattr(flags, "batch_size", None)
    if bs is not None and bs % max(n_devices, 1) != 0:
        raise ValueError(
            f"batch_size {bs} must be divisible by device count {n_devices}"
        )


# ---------------------------------------------------------------------------
# Style 3: argparse + JSON overlay
# ---------------------------------------------------------------------------

def maybe_merge_config_file(args, *, allow_invalid: bool = False):
    """Merge `args.config` JSON into an argparse Namespace, rejecting
    unknown keys (svox2/opt/util/config_util.py:130-140)."""
    config = getattr(args, "config", None)
    if not config:
        return args
    with open(config) as f:
        data = json.load(f)
    # "_"-prefixed keys are comments (shipped configs carry their
    # provenance in a "_comment" key)
    data = {k: v for k, v in data.items() if not k.startswith("_")}
    invalid = [k for k in data if not hasattr(args, k)]
    if invalid and not allow_invalid:
        raise ValueError(f"invalid config keys: {invalid}")
    for k, v in data.items():
        if hasattr(args, k) or allow_invalid:
            setattr(args, k, v)
    return args


def save_args_snapshot(args, out_dir: str):
    """args.json snapshot (svox2/opt/opt.py:286-289)."""
    os.makedirs(out_dir, exist_ok=True)
    payload = vars(args) if not isinstance(args, dict) else dict(args)
    with open(os.path.join(out_dir, "args.json"), "w") as f:
        json.dump({k: v for k, v in payload.items()}, f, indent=2, default=str)
