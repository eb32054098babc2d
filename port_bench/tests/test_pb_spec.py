"""BENCHMARK.json against the contract's shape; every cell resolves to
its files; a cell added as files alone is found and runs; the import
guard; the result line's keys."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_keys_names_and_units():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/") and (harness.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        names.append(entry["name"])
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    spec = harness.load_spec(cell)
    drv = harness.driver_module(spec)
    assert hasattr(drv, "Cell") and drv.FAULTS
    assert spec.traffic["limits"]
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)


def test_a_cell_added_as_files_alone_is_found_and_runs(tmp_path, small_spec):
    """A later PR adds a configuration, a traffic mix and a metric as new
    files and entries; no existing file of the harness changes."""
    shutil.copytree(harness.BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((harness.BENCH / "configs" / "plenoxels_syn512.json").read_text())
    cfg["reso"] = [64, 64, 64]
    (tmp_path / "port_bench" / "configs" / "plenoxels_dummy64.json").write_text(json.dumps(cfg))
    traffic = json.loads((harness.BENCH / "traffic" / "shell_frames_orbit40.json").read_text())
    traffic["scene"] = {"occupancy": "sphere", "opaque_sigma": None, "grid_radius": 1.0}
    traffic["camera"].update(width=32, height=32, focal=32.0, poses=2)
    traffic["check"].update(first_frames=1, frame_every=2, max_frames=2, tiles_per_frame=2)
    (tmp_path / "port_bench" / "traffic" / "fog_dummy.json").write_text(json.dumps(traffic))
    (tmp_path / "port_bench" / "metrics" / "frames_seen.frame.py").write_text(
        "def read(ctx):\n    return float(ctx['units']) if ctx['kind'] == 'frame' else None\n")
    bench["configs"].append({"name": "plenoxels_dummy64", "source": "https://arxiv.org/abs/2112.05131",
                             "file": "port_bench/configs/plenoxels_dummy64.json", "reduced": ["reso"], "why": "test"})
    bench["workloads"].append({"name": "dummy_fog", "config": "plenoxels_dummy64", "traffic": "fog_dummy", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "frames_seen.frame", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "frame_rays_per_s",
                               "workloads": ["dummy_fog"]})
    for m in bench["end_to_end"]:
        if m["name"] == "frame_rays_per_s":
            m["workloads"].append("dummy_fog")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.load_spec("dummy_fog", tmp_path)
    assert spec.config["reso"] == [64, 64, 64] and spec.traffic["scene"]["occupancy"] == "sphere"
    assert [m["name"] for m in spec.per_layer] == ["frames_seen.frame"]
    reader = harness.metric_reader("frames_seen.frame", spec.bench_dir)
    assert reader.read({"kind": "frame", "units": 3}) == 3.0
    from port_bench.run import run_cell

    out = run_cell(spec, 11, 0.2, False, device="cpu", require_launches=False)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frame_rays_per_s", "peak_mem_gib", "setup_s"}


def test_the_harness_imports_no_jax_nor_the_jax_package():
    assert harness.forbidden_imports() == []


def test_the_guard_compares_whole_top_level_names(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "ok.py").write_text("import nerf_projects_tpu_torch.core\nfrom nerf_projects_tpu_torch import ops\n"
                               "import jaxtyping\n")
    (pkg / "bad.py").write_text("import importlib\nfrom nerf_projects_tpu.ops import x\nimport jax.numpy as jnp\n"
                                "importlib.import_module('flax.linen')\n")
    assert harness.forbidden_imports(pkg) == [("pkg/bad.py", "flax"), ("pkg/bad.py", "jax"),
                                              ("pkg/bad.py", "nerf_projects_tpu")]
    assert harness.loaded_forbidden({"nerf_projects_tpu_torch.ops": 1, "jaxtyping": 1, "os": 1}) == []
    assert harness.loaded_forbidden({"jaxlib.xla": 1, "nerf_projects_tpu": 1}) == ["jaxlib", "nerf_projects_tpu"]


def test_the_result_line_keys_and_judge():
    ok, compared = harness.judge({"gap": 1e-6, "other": 5.0}, {"gap": 1e-4})
    assert ok and compared == {"gap": {"value": 1e-6, "limit": 1e-4}}
    assert not harness.judge({"gap": float("nan")}, {"gap": 1e-4})[0]
    assert not harness.judge({}, {"gap": 1e-4})[0]
    line = harness.result_line(True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                               {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                                "memory_peak_bytes": 123}, None, compared)
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    line = harness.result_line(False, 1, 0, {}, {"platform": "gpu"}, {"device_ops": [], "idle_gaps": []}, {})
    assert list(json.loads(line))[-1] == "compared" and "breakdown" in json.loads(line)


def test_run_exits_without_a_result_when_there_is_no_card():
    proc = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", "plenoxels_render_shell",
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          cwd=harness.ROOT, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_run_fails_in_a_directory_with_only_the_benchmark(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "plenoxels_render_shell", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                          timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
