"""The metric arithmetic on synthetic events: the device's busy union and
idle gaps, a tail over all frames, rates over the whole window, and the
per-layer readers."""
import json
import time

import pytest

from port_bench import harness

MS = 1_000_000  # ns


def trace(ops, spans=(), start=0, end=100 * MS):
    return harness.Trace(ops=sorted(ops, key=lambda o: o[1]), spans=list(spans), start_ns=start, end_ns=end)


def test_busy_is_the_union_of_overlapping_operations_inside_the_window():
    t = trace([("a", 10 * MS, 20 * MS), ("b", 15 * MS, 30 * MS), ("c", 50 * MS, 60 * MS),
               ("d", 95 * MS, 120 * MS), ("e", -5 * MS, 2 * MS)])
    # [10, 30] + [50, 60] + [95, 100] (clipped) + [0, 2] (clipped)
    assert t.busy_s() == pytest.approx((20 + 10 + 5 + 2) / 1e3)
    assert t.window_s == pytest.approx(0.1)


def test_idle_gaps_longest_first_named_by_the_open_span():
    t = trace([("a", 10 * MS, 20 * MS), ("b", 50 * MS, 60 * MS)],
              spans=[("bench.entry", 20 * MS, 40 * MS), ("bench.wait", 60 * MS, 100 * MS)])
    gaps = t.idle_gaps(10)
    assert [g[1] for g in gaps] == pytest.approx([0.040, 0.030, 0.010])
    assert [g[0] for g in gaps] == ["bench.wait", "bench.entry", "bench.loop"]


def test_op_seconds_and_top_ops():
    t = trace([("void march_kernel<9>", 0, 2 * MS), ("elementwise", 2 * MS, 3 * MS), ("march_bwd_kernel", 3 * MS, 7 * MS),
               ("elementwise", 8 * MS, 9 * MS)])
    assert t.op_seconds(("march_kernel",)) == pytest.approx(0.002)
    assert t.op_seconds(exclude=harness.HAND_WRITTEN) == pytest.approx(0.002)
    assert t.op_durations(("march_bwd_kernel",)) == pytest.approx([0.004])
    assert t.top_ops(2) == [["march_bwd_kernel", pytest.approx(0.004)], ["void march_kernel<9>", pytest.approx(0.002)]]


def test_p95_is_over_all_frames():
    xs = [float(i) for i in range(1, 101)]  # 1..100
    assert harness.percentile(xs, 95) == pytest.approx(95.05)
    assert harness.percentile([3.0], 95) == 3.0
    assert harness.percentile(list(reversed(xs)), 50) == pytest.approx(50.5)


class FakeCell:
    """A closed loop whose frames take 20 ms each."""
    closed = True
    units_per_call = 1
    rays_per_unit = 1000

    def __init__(self):
        self.after_calls = 0

    def issue(self, i):
        time.sleep(0.02)

    def after(self, i):
        self.after_calls += 1


def test_window_rate_is_all_rays_over_all_the_time():
    cell = FakeCell()
    w = harness.run_window(cell, 0.2, "cpu", harness.Spans(False))
    assert w.units == cell.after_calls == len(w.latencies) == len(w.entry_s)
    assert w.units >= 8
    assert w.seconds >= 0.2
    # the window ends after the last frame: the time covers every frame's
    assert w.seconds >= sum(w.latencies)
    assert w.rays == 1000 * w.units
    assert w.end_ns > w.start_ns


def test_pipelined_window_counts_steps_per_call():
    cell = FakeCell()
    cell.closed, cell.units_per_call = False, 5
    w = harness.run_window(cell, 0.1, "cpu", harness.Spans(True))
    assert w.units == 5 * len(w.entry_s)
    assert w.latencies == []


def test_leaf_gap_is_the_worst_leaf_against_the_larger_of_its_norm_and_the_median():
    want = {"a": 1.0, "b": 2.0, "c": 1e-9, "d": 4.0}
    got = {"a": 1.01, "b": 2.0, "c": 1e-3, "d": 3.0}
    # a: 0.01 over the median 1.5; c: 1e-3 over the median; d: 1 over 4
    assert harness.leaf_gap(got, want) == pytest.approx(0.25)
    assert harness.leaf_gap(got, want, skip=("d",)) == pytest.approx(0.01 / 1.5)
    assert harness.leaf_gap(want, want) == 0.0


def ctx(**kw):
    base = {"kind": "frame", "units": 10, "rays": 6_400_000, "window_s": 2.0, "busy_s": 0.5, "entry_s": 0.015,
            "glue_s": 0.004, "kernels": {"k3": {"bound_s": 0.001, "time_s": 0.01}},
            "model": {"bound_s": 0.002, "time_s": 0.04}}
    base.update(kw)
    return base


def test_readers():
    read = lambda name, c: harness.metric_reader(name).read(c)  # noqa: E731
    c = ctx()
    assert read("device_idle.frame", c) == pytest.approx(75.0)
    assert read("dispatch_ms.frame", c) == pytest.approx(1.5)
    assert read("glue_device_ms.frame", c) == pytest.approx(0.4)
    assert read("k3_roofline.frame", c) == pytest.approx(10.0)
    assert read("mfu.frame", c) == pytest.approx(5.0)
    r = ctx(kind="render", kernels={"k1f": {"bound_s": 0.004, "time_s": 0.01}})
    assert read("k1f_roofline.render", r) == pytest.approx(40.0)
    assert read("mfu.render", r) == pytest.approx(5.0)
    t = ctx(kind="train", kernels={"k2": {"bound_s": 0.003, "time_s": 0.01}, "k4": {"bound_s": 1, "time_s": 10}})
    assert read("k2_roofline.train", t) == pytest.approx(30.0)
    assert read("k4_roofline.train", t) == pytest.approx(10.0)
    assert read("dispatch_ms.train", t) == pytest.approx(1.5)
    # a reader that finds nothing returns nothing
    assert read("k1f_roofline.render", c) is None
    assert read("dispatch_ms.train", c) is None
    assert read("dispatch_ms.render", c) is None
    assert read("k3_roofline.frame", ctx(kernels={})) is None
    assert read("mfu.train", ctx(kind="train", model=None)) is None


def test_every_per_layer_metric_has_a_reader_and_names_a_reported_end_to_end_metric():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert harness.applies(moved, cell), (m["name"], cell)
