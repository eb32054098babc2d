"""The benchmark's general part: the cell's specification read from
``BENCHMARK.json`` and its files, the import guard, the measured window,
the reduction of a profiler trace, the per-layer metric readers and the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by name:

- ``BENCHMARK.json``'s configuration entry names its file
  (``configs/<config>.json``);
- a traffic mix is ``traffic/<traffic>.json``; its ``driver`` key names
  the general generator of that path (``drivers/<driver>.py``), which
  reads the rest of the file as parameters;
- a per-layer metric is ``metrics/<metric>.py`` with ``read(ctx)``,
  which returns a number or None (nothing to read: the metric is left
  out of the line);
- a kernel's operations and bytes are ``work/<kernel>.py``.
"""
from __future__ import annotations

import ast
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_projects_tpu")
HAND_WRITTEN = ("sm90_fwd_kernel", "sm90_dx_kernel", "sm90_dw_kernel", "mlp_grad_reduce_kernel", "composite_kernel",
                "march_kernel", "march_bwd_kernel", "sh_grad_reduce_kernel")


# ---------------------------------------------------------------------------
# The import guard
# ---------------------------------------------------------------------------

def _top(name: str) -> str:
    return name.split(".", 1)[0]


def imported_names(path: Path) -> set:
    """Top-level module names a source file imports: import statements,
    absolute ``from`` imports, and string arguments of ``import_module``
    and ``__import__``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {_top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(_top(node.module))
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if fname in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                names.add(_top(node.args[0].value))
    return names


def forbidden_imports(root: Path = BENCH) -> list:
    """(file, name) for every import under ``root`` of a forbidden top-level
    module, compared as whole names."""
    bad = []
    for path in sorted(root.rglob("*.py")):
        for name in sorted(imported_names(path) & set(FORBIDDEN)):
            bad.append((str(path.relative_to(root.parent)), name))
    return bad


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    mods = sys.modules if modules is None else modules
    return sorted({_top(m) for m in mods} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The specification
# ---------------------------------------------------------------------------

@dataclass
class Spec:
    cell: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path = BENCH

    @property
    def name(self) -> str:
        return self.cell["name"]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, its traffic and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    bench_dir = root / bench["paths"][0]
    return Spec(
        cell=cell,
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)],
        bench_dir=bench_dir,
    )


def load_file(path: Path, name: str):
    """A module from a file (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(spec: Spec):
    return importlib.import_module(f"port_bench.drivers.{spec.traffic['driver']}")


def metric_reader(name: str, bench_dir: Path = BENCH):
    return load_file(bench_dir / "metrics" / f"{name}.py", f"port_bench_metric_{name.replace('.', '_')}")


def peaks() -> dict:
    return json.loads((BENCH / "peaks.json").read_text())


# ---------------------------------------------------------------------------
# Time, spans and the window
# ---------------------------------------------------------------------------

def process_age_s(fallback_start: float) -> float:
    """Seconds since this process started (Linux: /proc), else since
    ``fallback_start`` on the perf_counter clock."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - fallback_start


class Sync:
    """The device's synchronisation, or nothing on the CPU."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"

    def all(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def event(self):
        if not self.cuda:
            return None
        ev = self.torch.cuda.Event()
        ev.record()
        return ev


class Spans:
    """Host spans of the harness's own calls into the program: (name,
    start_ns, end_ns) on the profiler's clock (``time.time_ns``), kept
    when a trace runs."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.done = []

    def __call__(self, name: str):
        return _Span(self, name) if self.traced else _NullSpan()


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.owner.done.append((self.name, self.t0, time.time_ns()))
        return False


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@dataclass
class Window:
    """What the measured window saw."""

    seconds: float = 0.0
    units: int = 0              # frames or steps completed
    rays: int = 0
    latencies: list = field(default_factory=list)   # closed loop: host seconds of each unit
    entry_s: list = field(default_factory=list)     # host seconds inside each entry call
    start_ns: int = 0           # the profiler's clock (time.time_ns)
    end_ns: int = 0


def run_window(cell, seconds: float, device, spans: Spans, depth: int = 2) -> Window:
    """Drive ``cell`` for ``seconds``. Each call is ``cell.issue(i)``, the
    entry into the program, which enqueues ``cell.units_per_call`` frames
    or steps. A closed loop (``cell.closed``) waits for each call to end
    (one viewer); otherwise at most ``depth`` calls are in flight, each
    ended by a CUDA event. The window ends after the last call has ended
    on the device: the rate is all the work over all the time."""
    sync = Sync(device)
    w = Window()
    events = []
    sync.all()
    w.start_ns = time.time_ns()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        with spans("bench.entry"):
            cell.issue(i)
        w.entry_s.append(time.perf_counter() - ts)
        if cell.closed:
            with spans("bench.wait"):
                sync.all()
            w.latencies.append(time.perf_counter() - ts)
        else:
            events.append(sync.event())
            if len(events) > depth and events[-1 - depth] is not None:
                with spans("bench.wait"):
                    events[-1 - depth].synchronize()
        with spans("bench.keep"):
            cell.after(i)
        i += 1
    with spans("bench.wait"):
        sync.all()
    w.seconds = time.perf_counter() - t0
    w.end_ns = time.time_ns()
    w.units = i * cell.units_per_call
    w.rays = w.units * cell.rays_per_unit
    return w


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of all values, linear between ranks."""
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    k = (len(xs) - 1) * q / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (k - lo))


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """The device's operations and the harness's spans in the traced
    window, on one clock (ns)."""

    ops: list            # (name, start_ns, end_ns), device kernels, copies and fills, by start
    spans: list          # (name, start_ns, end_ns), the harness's spans
    start_ns: int
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals in the window."""
        out = []
        for _, s, e in self.ops:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def op_seconds(self, names=None, exclude=None) -> float:
        """Device seconds of the operations whose name holds one of
        ``names`` (all with None), less those holding one of ``exclude``."""
        total = 0
        for n, s, e in self.ops:
            if names is not None and not any(k in n for k in names):
                continue
            if exclude is not None and any(k in n for k in exclude):
                continue
            total += e - s
        return total / 1e9

    def op_durations(self, names) -> list:
        """Seconds of each operation whose name holds one of ``names``, in
        launch order."""
        return [(e - s) / 1e9 for n, s, e in self.ops if any(k in n for k in names)]

    def top_ops(self, k: int = 10) -> list:
        tot = {}
        for n, s, e in self.ops:
            tot[n] = tot.get(n, 0) + (e - s)
        return [[n[:160], v / 1e9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def span_at(self, t: int) -> str:
        """The innermost harness span open at ``t``, or the loop."""
        best = None
        for n, s, e in self.spans:
            if s <= t < e and (best is None or s >= best[1]):
                best = (n, s)
        return best[0] if best else "bench.loop"

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest gaps with no device operation, each named by
        the harness span open on the host when it began."""
        busy = self.busy_intervals()
        edges = [self.start_ns] + [x for iv in busy for x in iv] + [self.end_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.span_at(s), (e - s) / 1e9] for s, e in gaps[:k]]


def read_trace(prof, spans: Spans, start_ns: int, end_ns: int) -> Trace:
    """The device operations of a finished ``torch.profiler.profile`` (its
    raw events, on the host's wall clock) and the harness's spans."""
    from torch.autograd import DeviceType

    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    ops.sort(key=lambda o: o[1])
    return Trace(ops=ops, spans=list(spans.done), start_ns=start_ns, end_ns=end_ns)


# ---------------------------------------------------------------------------
# The device and the result
# ---------------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
        return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout.strip() else \
            f"nvidia-smi exit {proc.returncode}"
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"


def device_block(chips: int) -> dict:
    import torch

    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips)),
    }


def leaf_gap(got: dict, want: dict, skip=()) -> float:
    """The worst leaf's gap between two norms by leaf, |got - want| over
    the larger of want and the median leaf's want (some gradients are all
    but zero), leaving out the leaves in ``skip``."""
    med = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in want if k not in skip)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, compared): every number compared is finite and at most
    its limit; compared maps each name to its value and limit."""
    compared, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        compared[name] = {"value": v, "limit": lim}
    return ok, compared


def result_line(correct, attempted, failed, metrics, device, breakdown, compared) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return json.dumps(out)
