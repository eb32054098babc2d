"""Percent of the rows the dense optimizer sweep visits that the step
flagged (K4's touched bricks and the TV rows): the program's
``plenoxels.rows_flagged`` over ``plenoxels.rows_swept`` counters
(obs/trace.py, traced run); layer: train glue."""
from port_bench import program


def read(ctx):
    rec = program.recording(ctx)
    if rec is None or ctx["kind"] != "train" or not rec.counters.get("plenoxels.rows_swept"):
        return None
    return 100.0 * rec.counters.get("plenoxels.rows_flagged", 0) / rec.counters["plenoxels.rows_swept"]
