#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card at
a cell's own size, all seeds in one process:

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 ... [--seconds 2] [--faults] [--out file]

For each seed: the cell's set-up, a short window at the cell's own load,
then the numbers compared for the program (the lower readings) and for
the control, the reference in the next lower precision put in the
program's place (the upper readings); with ``--faults``, a run with each
of the driver's faults of the timed path planted, whose numbers are read
too. Each reading is one JSON line on standard output (and in ``--out``).
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(spec, seed: int, seconds: float, device: str, fault=None) -> dict:
    """Set up, drive ``seconds`` and read the program's and the
    control's numbers of one seed (only the program's with a fault)."""
    import torch

    from port_bench import harness

    drv = harness.driver_module(spec)
    t0 = time.perf_counter()
    cell = drv.Cell(spec, seed, device, fault=fault)
    window = harness.run_window(cell, seconds, device, harness.Spans(False))
    cell.release()
    out = {"seed": seed, "fault": fault, "units": window.units, "setup_s": time.perf_counter() - t0 - window.seconds,
           "program": cell.check(control=False)}
    if fault is None:
        out["control"] = cell.check(control=True)
    del cell
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--no-control", dest="control", action="store_false")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from port_bench import harness

    spec = harness.load_spec(args.workload, ROOT)
    faults = list(harness.driver_module(spec).FAULTS) if args.faults else []
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            runs = ([None] if args.control else []) + faults
            for fault in runs:
                r = readings(spec, seed, args.seconds, "cuda", fault)
                r["workload"] = args.workload
                line = json.dumps(r)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
