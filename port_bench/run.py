#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this process
sees.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and ``nerf_projects_tpu_torch/``. Set-up makes the cell's inputs and
weights from ``--seed`` on the card, builds the program's objects and
warms every shape the traffic uses; the window then drives the program
for ``--seconds``; afterwards the answers the window produced are held
against the plain reference under ``port_bench/reference/``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read from a torch.profiler trace
of the window), ``device``, with ``--trace 1`` a ``breakdown``, and last
``compared``: each number compared with its limit, which standard
error's last lines repeat. The card's name and power limit go to
standard error first.

Exit codes: 0 with a result; 2 without a card (or with fewer than the
cell asks for); 3 when a forbidden module (JAX, flax, the JAX package) is
imported by the harness or loaded in this process. Kernel builds and
caches stay inside the checkout: the port builds into
``nerf_projects_tpu_torch/_build/``, Triton (should a kernel ever use it)
into ``port_bench/.cache/triton``.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
CACHE = ROOT / "port_bench" / ".cache"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(spec, seed: int, seconds: float, trace: bool, device="cuda", t_start: float = None,
             fault=None, control: bool = False, require_launches: bool = True) -> dict:
    """Set up, drive and check one run of the cell: dict(correct,
    attempted, failed, metrics, device, breakdown, compared, numbers).
    ``fault`` breaks the timed path underneath (a name of the driver's
    FAULTS); ``control`` puts the reference in the nearest lower precision
    in the program's place for the comparison."""
    import torch

    from port_bench import harness

    t_start = time.perf_counter() if t_start is None else t_start
    drv = harness.driver_module(spec)
    cell = drv.Cell(spec, seed, device, fault=fault)
    on_card = torch.device(device).type == "cuda"
    cell.zero_launches()
    cell.traced = trace
    spans = harness.Spans(trace)
    length = min(seconds, float(spec.traffic.get("trace_seconds", seconds))) if trace else seconds
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # the device's activity only: recording every host operator would
        # slow the host's dispatch, which is what several cells measure
        prof = profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU])
        prof.__enter__()
    setup_s = harness.process_age_s(t_start)
    try:
        window = harness.run_window(cell, length, device, spans)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    launches = cell.launches()
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(spec.cell["chips"])) if on_card else 0
    metrics, breakdown = {}, None
    dev = harness.device_block(spec.cell["chips"]) if on_card else {"platform": "cpu", "kind": "cpu", "count": 1,
                                                                      "memory_peak_bytes": 0}
    if trace:
        tr = harness.read_trace(prof, spans, window.start_ns, window.end_ns)
        ctx = cell.trace_context(window, tr, harness.peaks())
        ctx.update(kind=cell.kind, units=window.units, rays=window.rays, window_s=tr.window_s, busy_s=tr.busy_s(),
                   entry_s=sum(window.entry_s), glue_s=tr.op_seconds(exclude=harness.HAND_WRITTEN))
        for m in spec.per_layer:
            v = harness.metric_reader(m["name"], spec.bench_dir).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    else:
        candidates = {
            "setup_s": setup_s,
            "peak_mem_gib": peak / 2**30,
            f"{cell.kind}_rays_per_s": window.rays / window.seconds,
        }
        if window.latencies:
            candidates[f"{cell.kind}_ms_p95"] = 1e3 * harness.percentile(window.latencies, 95)
        for m in spec.end_to_end:
            if m["name"] not in candidates:
                raise RuntimeError(f"{spec.name} cannot report {m['name']}")
            metrics[m["name"]] = {"value": candidates[m["name"]], "unit": m["unit"]}
    cell.release()
    numbers = cell.check(control=control)
    limits = dict(spec.traffic["limits"])
    if require_launches:
        numbers["kernels_not_launched"] = float(sum(1 for v in launches.values() if v <= 0))
        limits["kernels_not_launched"] = 0.0
    correct, compared = harness.judge(numbers, limits)
    return {"correct": correct, "attempted": window.units, "failed": 0, "metrics": metrics, "device": dev,
            "breakdown": breakdown, "compared": compared, "numbers": numbers, "launches": launches,
            "window_s": window.seconds, "setup_s": setup_s}


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    from port_bench import harness

    bad = harness.forbidden_imports()
    if bad:
        print("forbidden imports under port_bench/: " + ", ".join(f"{f} imports {n}" for f, n in bad), file=sys.stderr)
        return 3
    spec = harness.load_spec(args.workload, ROOT)
    import torch

    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{spec.name} needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    loaded = harness.loaded_forbidden()
    if loaded:
        print(f"forbidden modules loaded in this process: {loaded}", file=sys.stderr)
        return 3
    print(f"launches in the window: {out['launches']}; window {out['window_s']:.6f} s; set-up {out['setup_s']:.6f} s",
          file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared: {name} {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out["correct"], out["attempted"], out["failed"], out["metrics"], out["device"],
                              out["breakdown"], out["compared"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
