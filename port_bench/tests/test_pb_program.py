"""The readers of the program's own spans and counters
(``port_bench/program.py``, ``nerf_projects_tpu_torch/obs/trace.py``) on
synthetic recordings; idle gaps named by the program's spans; a traced
run against a program without the recorder; and, on the card, the
program's spans on the device trace's clock, its device timings and its
count of the host's waits."""
import json
import sys

import pytest

from nerf_projects_tpu_torch import obs
from nerf_projects_tpu_torch.obs import trace
from port_bench import harness
from port_bench.program_report import innermost, report
from port_bench.run import run_cell

MS = 1_000_000  # ns
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NEW = [m["name"] for m in BENCH["per_layer"] if m["source"] in ("program_span", "program_counter")]


@pytest.fixture(autouse=True)
def no_recording():
    trace.stop()
    yield
    trace.stop()


def read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def ctx(kind, rec, units=2):
    return {"kind": kind, "units": units, "program": rec}


def frames():
    """Two frames: pack 1 ms (0.25 of it in a collection), launch 0.5 ms,
    outputs 0.25 ms; a Plenoxels step's march.pack outside any frame."""
    return trace.Recording(spans=[
        ("frame", 0, 4 * MS, -1, 0),
        ("march.pack", 0, 1 * MS, 0, 0),
        ("k3.launch", 1 * MS, 1.5 * MS, 0, 0),
        ("frame.outputs", 2 * MS, 2.25 * MS, 0, 0),
        ("frame", 10 * MS, 13 * MS, -1, 4),
        ("march.pack", 10 * MS, 11 * MS, 4, 4),
        ("k3.launch", 11 * MS, 11.5 * MS, 4, 4),
        ("frame.outputs", 12 * MS, 12.25 * MS, 4, 4),
        ("plenoxels.step", 20 * MS, 30 * MS, -1, 8),
        ("march.pack", 20 * MS, 29 * MS, 8, 8),
        ("py.gc", 10.5 * MS, 10.75 * MS, 5, 4),
    ], counters={"host.syncs": 4, "alloc.device_mallocs": 1}, watched_syncs=True)


def test_frame_readers():
    rec = frames()
    c = ctx("frame", rec)
    assert read("pack_host_ms.frame", c) == pytest.approx((1.0 + 0.75) / 2)
    assert read("launch_host_ms.frame", c) == pytest.approx(0.5)
    assert read("outputs_host_ms.frame", c) == pytest.approx(0.25)
    assert read("gc_ms.frame", c) == pytest.approx(0.125)
    assert read("device_mallocs.frame", c) == pytest.approx(0.5)
    assert read("host_syncs.frame", c) == pytest.approx(2.0)
    # another kind of cell, or a recording without the counters, reads nothing
    assert read("pack_host_ms.frame", ctx("train", rec)) is None
    assert read("host_syncs.render", ctx("frame", rec)) is None
    bare = trace.Recording(spans=rec.spans)
    assert read("host_syncs.frame", ctx("frame", bare)) is None
    assert read("device_mallocs.frame", ctx("frame", bare)) is None


def test_render_and_train_readers():
    view = trace.Recording(spans=[
        ("view", 0, 100 * MS, -1, 0),
        ("nerf.sample", 0, 1 * MS, 0, 0),
        ("nerf.encode", 1 * MS, 2 * MS, 0, 0),
        ("nerf.encode", 2 * MS, 3 * MS, 0, 0),
        ("nerf.mlp", 3 * MS, 4 * MS, 0, 0),
        ("nerf.composite", 4 * MS, 5 * MS, 0, 0),
    ], device_ms={1: 10.0, 2: 20.0, 3: 6.0, 4: 40.0, 5: 8.0}, counters={}, watched_syncs=True)
    c = ctx("render", view, units=1)
    assert read("sample_device_ms.render", c) == pytest.approx(10.0)
    assert read("encode_device_ms.render", c) == pytest.approx(26.0)
    assert read("composite_device_ms.render", c) == pytest.approx(8.0)
    assert read("host_syncs.render", c) == 0.0
    # host-only spans (the CPU) give no device metric
    assert read("sample_device_ms.render", ctx("render", trace.Recording(spans=view.spans), 1)) is None

    steps = trace.Recording(spans=[
        ("plenoxels.step", 0, 70 * MS, -1, 0),
        ("plenoxels.march", 0, 3 * MS, 0, 0),
        ("plenoxels.accumulate", 3 * MS, 4 * MS, 0, 0),
        ("plenoxels.sweep", 4 * MS, 70 * MS, 0, 0),
    ], device_ms={1: 3.0, 2: 1.0, 3: 60.0},
        counters={"plenoxels.rows_flagged": 300.0, "plenoxels.rows_swept": 61297 * 2, "host.syncs": 0},
        watched_syncs=True)
    c = ctx("train", steps, units=2)
    assert read("march_device_ms.train", c) == pytest.approx(1.5)
    assert read("sweep_device_ms.train", c) == pytest.approx(30.0)
    assert read("sweep_useful_share.train", c) == pytest.approx(100.0 * 300 / (2 * 61297))
    assert read("host_syncs.train", c) == 0.0
    nerf = trace.Recording(spans=[("nerf.step", 0, 5 * MS, -1, 0)], counters={"host.syncs": 2}, watched_syncs=True)
    assert read("host_syncs.train", ctx("train", nerf)) == pytest.approx(1.0)
    assert read("march_device_ms.train", ctx("train", nerf)) is None
    assert read("sweep_useful_share.train", ctx("train", nerf)) is None


def test_the_first_reader_ends_the_recording_and_the_others_share_it():
    trace.start()
    with trace.span("frame"):
        with trace.span("march.pack"):
            pass
    c = {"kind": "frame", "units": 1}
    assert read("pack_host_ms.frame", c) >= 0.0 and not trace.recording()
    rec = c["program"]
    assert read("outputs_host_ms.frame", c) == 0.0 and c["program"] is rec


def test_idle_gaps_are_named_by_the_program_spans_inside_the_entry():
    ops = [("a", 0, 1 * MS), ("b", 5 * MS, 6 * MS), ("b", 7.5 * MS, 8.2 * MS), ("c", 9.5 * MS, 10 * MS)]
    bench = [("bench.entry", 1 * MS, 8 * MS), ("bench.wait", 8 * MS, 9 * MS)]
    prog = [("frame", 1 * MS, 8 * MS), ("march.pack", 1 * MS, 4 * MS), ("frame.outputs", 7 * MS, 7.5 * MS)]
    t = harness.Trace(ops=ops, spans=bench + prog, start_ns=0, end_ns=10 * MS)
    assert [g[0] for g in t.idle_gaps(3)] == ["march.pack", "frame", "bench.wait"]
    at = innermost(bench + prog)
    assert at(7.2 * MS) == "frame.outputs" and at(4.5 * MS) == "frame" and at(8.5 * MS) == "bench.wait"
    assert at(0) is None

    rec = trace.Recording(spans=[(n, s, e, -1 if n == "frame" else 0, 0) for n, s, e in prog])
    out = report("frame", 1, 0.007, harness.Trace(ops=ops, spans=bench, start_ns=0, end_ns=10 * MS), rec)
    assert out["entry_idle_named_share"] == 1.0 and out["entry_idle_ms"] == pytest.approx(5.5)
    assert out["entry_idle_ms_by_span"] == {"march.pack": pytest.approx(4.0), "frame": pytest.approx(1.5)}
    assert out["idle_gaps"][0] == ["march.pack", pytest.approx(0.004)]
    assert out["coverage"] == pytest.approx((3.0 + 0.5) / 7.0)


def test_a_program_without_the_recorder(small_spec, monkeypatch):
    """The parent's program: no recorder to import and no spans. The new
    readers find nothing and the line leaves them out; the others read
    as before."""
    spec = small_spec("plenoxels_render_shell")
    with_rec = run_cell(spec, 2**31 + 5, 0.3, True, device="cpu", require_launches=False)
    assert {"pack_host_ms.frame", "outputs_host_ms.frame", "gc_ms.frame"} <= set(with_rec["metrics"])
    monkeypatch.setattr(trace, "_PROFILER", trace._NoProfiler)
    monkeypatch.setitem(sys.modules, "nerf_projects_tpu_torch.obs.trace", None)
    monkeypatch.delattr(obs, "trace")
    without = run_cell(spec, 2**31 + 5, 0.3, True, device="cpu", require_launches=False)
    assert without["correct"]
    assert not set(without["metrics"]) & set(NEW)
    assert set(without["metrics"]) == set(with_rec["metrics"]) - set(NEW)


# -- the card ----------------------------------------------------------------

@pytest.mark.card
def test_program_spans_are_on_the_device_trace_clock(card):
    """A span around a launch starts before the launch's device start, and
    less than 50 ms before it, in a profile taken as the traced run takes
    it; its CUDA events time the launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        with trace.span("frame", device=True):
            torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    rec = trace.stop()
    tr = harness.read_trace(prof, harness.Spans(False), 0, 2**62)
    name, d0, d1 = max(tr.ops, key=lambda o: o[2] - o[1])
    (root,) = rec.roots("frame")
    s0 = rec.spans[root][1]
    assert s0 <= d0 < s0 + 50 * MS, (name, s0, d0)
    assert rec.device_ms[root] == pytest.approx((d1 - d0) / 1e6, rel=0.2)


@pytest.mark.card
def test_host_syncs_and_mallocs_are_counted_inside_root_spans(card):
    import torch

    x = torch.ones(1000, device=card)
    torch.cuda.synchronize()
    trace.start()
    x.sum().item()                      # the harness's own read: not counted
    with trace.span("frame"):
        x.sum().item()                  # the program's: counted at this line
        y = torch.empty(2**28, dtype=torch.uint8, device=card)
        del y
    rec = trace.stop()
    assert rec.watched_syncs and rec.counters["host.syncs"] == 1
    (site,) = rec.sync_sites
    assert site.startswith(__file__)
    assert rec.counters["alloc.device_mallocs"] >= 0
    assert torch.cuda.get_sync_debug_mode() == 0
