"""Dataset-prep CLI: the svox2/opt/scripts entry points as subcommands
(port of ``nerf_projects_tpu/cli/data_prep.py``, the same flags; it
makes no tensor, so it takes no ``--device``).

  create_split ROOT [--every N] [--dry_run] [--random]
  unsplit ROOT [--dry_run]
  run_colmap ROOT [--colmap-bin colmap] [--known-intrin] [--sequential]
  record3d DATA_DIR [--every N] [--factor N]
  extract_metrics CKPT_ROOT [--out CSV]
"""
from __future__ import annotations

import argparse
import json

from nerf_projects_tpu_torch.data import prep


def main(argv=None):
    p = argparse.ArgumentParser(description="dataset preparation tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("create_split")
    s.add_argument("root_dir")
    s.add_argument("--every", type=int, default=16)
    s.add_argument("--dry_run", action="store_true")
    s.add_argument("--random", action="store_true")

    s = sub.add_parser("unsplit")
    s.add_argument("root_dir")
    s.add_argument("--dry_run", action="store_true")

    s = sub.add_parser("run_colmap")
    s.add_argument("root_dir")
    s.add_argument("--colmap-bin", default="colmap")
    s.add_argument("--known-intrin", action="store_true")
    s.add_argument("--fix-intrin", action="store_true")
    s.add_argument("--sequential", action="store_true")
    s.add_argument("--max-width", type=int, default=1280)
    s.add_argument("--max-height", type=int, default=768)
    s.add_argument("--every", type=int, default=16)
    s.add_argument("--dry_run", action="store_true",
                   help="print the colmap commands without running")

    s = sub.add_parser("record3d")
    s.add_argument("data_dir")
    s.add_argument("--every", type=int, default=15)
    s.add_argument("--factor", type=int, default=2)

    s = sub.add_parser("extract_metrics")
    s.add_argument("ckpt_root")
    s.add_argument("--out", default=None)

    args = p.parse_args(argv)

    if args.cmd == "create_split":
        renames = prep.create_split(
            args.root_dir, every=args.every, dry_run=args.dry_run,
            randomize=args.random,
        )
        for old, new in renames:
            print(f"rename {old} -> {new}")
        print(f"({len(renames)} files{' — dry run' if args.dry_run else ''})")
    elif args.cmd == "unsplit":
        renames = prep.unsplit(args.root_dir, dry_run=args.dry_run)
        for old, new in renames:
            print(f"rename {old} -> {new}")
        print(f"({len(renames)} files{' — dry run' if args.dry_run else ''})")
    elif args.cmd == "run_colmap":
        if args.dry_run:
            res = prep.run_colmap(
                args.root_dir, colmap_bin=args.colmap_bin,
                known_intrin=args.known_intrin, fix_intrin=args.fix_intrin,
                sequential=args.sequential, run=False,
            )
            for cmd in res.commands:
                print(" ".join(cmd))
        else:
            out = prep.preprocess_colmap(
                args.root_dir, colmap_bin=args.colmap_bin,
                max_width=args.max_width, max_height=args.max_height,
                every=args.every,
            )
            print(json.dumps(
                {"n_images": out["n_images"],
                 "n_renamed": len(out.get("renames", []))}
            ))
    elif args.cmd == "record3d":
        n = prep.proc_record3d(args.data_dir, every=args.every,
                               factor=args.factor)
        print(f"wrote {n} frames")
    elif args.cmd == "extract_metrics":
        rows = prep.extract_metrics(args.ckpt_root, args.out)
        print(json.dumps(rows, indent=2, default=float))


if __name__ == "__main__":
    main()
