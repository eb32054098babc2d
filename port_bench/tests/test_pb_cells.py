"""Each cell driven end to end at a size the CPU holds (the port's plain
versions stand in for its kernels there): sound runs come out correct;
the control (the reference in the next lower precision in the program's
place) and every fault of the timed path that the cell can have come
out not correct. At the cells' own sizes the same runs are made on the
card (``card`` marker, and ``port_bench/control.py`` for the readings
the limits were set from)."""
import json

import pytest

from port_bench import harness
from port_bench.run import run_cell

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
FAULTS = [(c, f) for c in CELLS for f in harness.driver_module(harness.load_spec(c)).FAULTS]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(cell, trace, small_spec):
    spec = small_spec(cell)
    out = run_cell(spec, 2**31 + 17, 0.3, trace, device="cpu", require_launches=False)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {m["name"] for m in (spec.per_layer if trace else spec.end_to_end)}
    if trace:
        # on the CPU the trace holds no device operation: only the host's
        # and the dispatch's readers find something
        assert set(out["metrics"]) <= names and out["breakdown"] is not None
    else:
        assert set(out["metrics"]) == names


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, small_spec):
    out = run_cell(small_spec(cell), 5, 0.2, False, device="cpu", control=True, require_launches=False)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault, small_spec):
    out = run_cell(small_spec(cell), 6, 0.2, False, device="cpu", fault=fault, require_launches=False)
    assert not out["correct"], out["compared"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, card):
    spec = harness.load_spec(cell)
    out = run_cell(spec, 2**31 + 23, 2.0, False, device=card)
    assert out["correct"], out["compared"]
    assert all(v > 0 for v in out["launches"].values())
