"""Vanilla-NeRF training CLI (port of ``nerf_projects_tpu/cli/train_nerf.py``).

Usage (consumes the reference's nerf/yaml/* configs as-is; PyYAML is
imported only when a config file is read):
    python -m nerf_projects_tpu_torch.cli.train_nerf --config path/to/config.yaml \\
        [--max_iters N] [--device cpu] [--<config key> value ...]
"""
from __future__ import annotations

import argparse

from nerf_projects_tpu_torch.train.loop import train
from nerf_projects_tpu_torch.utils.config import load_or_create_config


def main(argv=None):
    p = argparse.ArgumentParser(description="Train vanilla NeRF (H100)")
    p.add_argument("--config", type=str, default=None, help="YAML config path")
    p.add_argument("--max_iters", type=int, default=None,
                   help="override N_iters (smoke runs)")
    p.add_argument("--device", type=str, default=None, help="torch device (default: the card)")
    args, overrides = p.parse_known_args(argv)
    cfg = load_or_create_config(args.config)
    # simple --key value overrides, cast to the type of the value replaced
    it = iter(overrides)
    for tok in it:
        if tok.startswith("--"):
            key = tok[2:]
            val = next(it, None)
            if key in cfg and val is not None:
                old = cfg[key]
                if isinstance(old, bool):
                    cfg[key] = val.lower() in ("1", "true", "yes")
                elif isinstance(old, int):
                    cfg[key] = int(val)
                elif isinstance(old, float):
                    cfg[key] = float(val)
                else:
                    cfg[key] = val
    return train(cfg, max_iters=args.max_iters, device=args.device)


if __name__ == "__main__":
    main()
