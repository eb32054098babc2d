"""Analysis-suite CLI — the plenoctree/analysis/run_all_analysis.py
equivalent: one command that emits every dashboard for a directory of
experiment logs (port of ``nerf_projects_tpu/cli/run_analysis.py``, the
same flags; host-side, matplotlib needed).

Usage:
  python -m nerf_projects_tpu_torch.cli.run_analysis BASE_DIR [--experiment X]
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="Emit analysis dashboards")
    p.add_argument("base_dir", help="directory of experiment directories")
    p.add_argument("--experiment", default=None,
                   help="only this experiment subdirectory")
    p.add_argument("--json", action="store_true",
                   help="print the produced-file manifest as JSON")
    args = p.parse_args(argv)

    from nerf_projects_tpu_torch.obs import dashboards

    if args.experiment:
        import os

        d = os.path.join(args.base_dir, args.experiment)
        outs = [
            f(d)
            for f in (
                dashboards.scene_dashboard,
                dashboards.timing_chart,
                dashboards.efficiency_report,
            )
        ]
        manifest = {"per_experiment": [{"dir": d, "figures":
                                        [o for o in outs if o]}]}
    else:
        manifest = dashboards.run_all(args.base_dir)
    if args.json:
        print(json.dumps(manifest, indent=2))
    else:
        n = sum(len(e["figures"]) for e in manifest["per_experiment"])
        print(f"wrote {n} per-experiment figures + "
              f"{len(manifest.get('global', []))} global outputs")


if __name__ == "__main__":
    main()
