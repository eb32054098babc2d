"""The program's own spans and counters (``nerf_projects_tpu_torch/
obs/trace.py``) for the per-layer readers.

The program's recorder follows the torch profiler, so a traced run's
window is recorded in the program too. The first reader that asks ends
that recording and keeps it in ``ctx["program"]`` for the others. A
program without the recorder gives None, and its readers return None:
the metric is left out of the line."""
from __future__ import annotations

# the root span of each kind of unit the cells drive
ROOTS = {"frame": "frame", "render": "view"}
TRAIN_ROOTS = ("nerf.step", "plenoxels.step")


def recording(ctx: dict):
    """The program's recording of the traced window, or None."""
    if "program" not in ctx:
        try:
            from nerf_projects_tpu_torch.obs import trace
        except ImportError:
            ctx["program"] = None
        else:
            ctx["program"] = trace.stop()
    return ctx["program"]


def per_unit(ctx: dict, kind: str, value_of):
    """``value_of(recording)`` over the window's units, for a cell of
    ``kind`` whose window the program recorded; else None."""
    rec = recording(ctx)
    if rec is None or ctx["kind"] != kind or not ctx["units"]:
        return None
    roots = (ROOTS[kind],) if kind in ROOTS else TRAIN_ROOTS
    if not any(rec.roots(r) for r in roots):
        return None
    return value_of(rec) / ctx["units"]


def host_syncs(ctx: dict, kind: str):
    """The host's waits for the card inside the program's calls, a unit."""
    rec = recording(ctx)
    if rec is None or not rec.watched_syncs:
        return None
    return per_unit(ctx, kind, lambda r: r.counters.get("host.syncs", 0))


def device_ms(ctx: dict, kind: str, name: str, under: str):
    """Device milliseconds a unit in the program's ``name`` spans inside
    its ``under`` roots (CUDA events at the spans' edges); None without
    device timings."""
    rec = recording(ctx)
    if rec is None or not rec.device_ms or not rec.roots(under):
        return None
    return per_unit(ctx, kind, lambda r: r.device_total_ms(name, under=under))
