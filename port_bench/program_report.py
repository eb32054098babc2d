#!/usr/bin/env python3
"""One traced window of a cell with the program's own spans beside the
device's operations.

    python3 port_bench/program_report.py --workload <cell> --seed <n> [--seconds <s>] [--record 0|1] [--out <json>]

from the root of a checkout, on a card. Set-up and the window are the
benchmark's (``harness.run_window`` under a CUDA-only profiler, for the
traffic's ``trace_seconds`` unless ``--seconds``); the program's recorder
(``nerf_projects_tpu_torch/obs/trace.py``) follows the profiler, or with
``--record 0`` stays off. Prints, and writes to ``--out``:

- the program's spans by name (count, host, self and device ms) and its
  counters, with the Python lines of any host syncs;
- the host ms a unit inside the harness's entry call (``dispatch_ms``),
  the device's busy ms a unit, and the coverage of the unit by its
  phases: a frame's ``march.pack`` + ``k3.launch`` + ``frame.outputs``
  self times over its entry time; a NeRF view's ``nerf.sample`` +
  ``nerf.encode`` + ``nerf.mlp`` + ``nerf.composite`` device ms, or a
  Plenoxels step's ``plenoxels.march`` + ``plenoxels.accumulate`` +
  ``plenoxels.sweep``, over the busy device time;
- the ten longest idle gaps of the device, each named by the innermost
  span open on the host at its start, the program's spans included, and
  the idle time that begins inside ``bench.entry`` a unit, by the span
  that names it, and the share of it that a program span names.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PHASES = {
    "frame": ("frame", ("march.pack", "k3.launch", "frame.outputs")),
    "render": ("view", ("nerf.sample", "nerf.encode", "nerf.mlp", "nerf.composite")),
    "train": ("plenoxels.step", ("plenoxels.march", "plenoxels.accumulate", "plenoxels.sweep")),
}


def innermost(spans: list):
    """A function t -> the name of the innermost span open at t (None if
    none), for properly nested (name, start_ns, end_ns) spans."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    starts = [s[1] for s in spans]

    def at(t):
        j = bisect.bisect_right(starts, t) - 1
        while j >= 0:
            name, s, e = spans[j]
            if s <= t < e:
                return name
            j -= 1
        return None
    return at


def idle_gaps(trace) -> list:
    """(start_ns, end_ns) of every stretch with no device operation."""
    edges = [trace.start_ns] + [x for iv in trace.busy_intervals() for x in iv] + [trace.end_ns]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]


def report(kind: str, units: int, entry_s: float, trace, rec) -> dict:
    """The numbers this script prints, from a window's trace (harness
    spans only) and the program's recording (or None)."""
    busy_ms = 1e3 * trace.busy_s() / units
    out = {"units": units, "dispatch_ms": 1e3 * entry_s / units, "busy_ms": busy_ms,
           "idle_share": 1.0 - trace.busy_s() / trace.window_s}
    if rec is None:
        return out
    out["spans"] = rec.summary()
    out["counters"] = rec.counters
    out["sync_sites"] = rec.sync_sites
    root, phases = PHASES[kind]
    if not rec.roots(root):
        parts, out["coverage"] = {}, None
    elif kind == "frame":
        parts = {p: rec.host_ms(p, under=root, self_time=True) / units for p in phases}
        out["coverage"] = sum(parts.values()) / out["dispatch_ms"]
    else:
        parts = {p: rec.device_total_ms(p, under=root) / units for p in phases}
        out["coverage"] = sum(parts.values()) / busy_ms if busy_ms else None
    out["phases_ms"] = parts
    program = [(s[0], s[1], s[2]) for s in rec.spans]
    harness_at, both_at = innermost(trace.spans), innermost(trace.spans + program)
    gaps = idle_gaps(trace)
    by_name = {}
    for s, e in gaps:
        if harness_at(s) == "bench.entry":
            name = both_at(s)
            by_name[name] = by_name.get(name, 0) + e - s
    in_entry = sum(by_name.values())
    out["entry_idle_ms"] = in_entry / 1e6 / units
    out["entry_idle_named_share"] = 1.0 - by_name.get("bench.entry", 0) / in_entry if in_entry else None
    out["entry_idle_ms_by_span"] = {k: v / 1e6 / units for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}
    gaps.sort(key=lambda g: g[0] - g[1])
    out["idle_gaps"] = [[both_at(s) or "bench.loop", (e - s) / 1e9] for s, e in gaps[:10]]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--record", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerf_projects_tpu_torch.obs import trace
    from port_bench import harness

    if not torch.cuda.is_available():
        print("program_report.py needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    spec = harness.load_spec(args.workload, ROOT)
    cell = harness.driver_module(spec).Cell(spec, args.seed, "cuda")
    cell.traced = True
    if not args.record:
        trace._PROFILER = trace._NoProfiler  # the recorder no longer follows the profiler
    spans = harness.Spans(True)
    seconds = args.seconds or float(spec.traffic.get("trace_seconds", 3.0))
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        window = harness.run_window(cell, seconds, "cuda", spans)
    finally:
        prof.__exit__(None, None, None)
    rec = trace.stop()
    tr = harness.read_trace(prof, spans, window.start_ns, window.end_ns)
    out = report(cell.kind, window.units, sum(window.entry_s), tr, rec)
    out.update(workload=spec.name, seed=args.seed, record=args.record, card=harness.card_line(),
               device=torch.cuda.get_device_name(0))
    if rec is not None:
        print(rec.table(), file=sys.stderr)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
