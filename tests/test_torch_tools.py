"""The port's environment check (``cli/check_env.py``), task manager
(``pipeline/task_manager.py``) and analysis CLI (``cli/run_analysis.py``)
against the JAX package's, on the same inputs.

check_env: with ``--device cpu`` the port's table is all green, its rows
follow JAX's (the first two check the port's toolchain instead of JAX's)
and the grid and octree rows' details equal those of JAX's own rows; with
no argument and no card it fails its device rows and exits 1. JAX's table
comes from its ``main`` with ``check`` patched to run only the rows the
port repeats at JAX's configuration (the module fixture ``jax_rows``), its
grid render jitted (eager, each of its ops compiles on its own).

The task manager: JAX's tests/test_task_manager.py on both packages, the
results equal (the same subprocesses), the port's also on a spawn pool of
two workers. run_analysis: JAX's tests/test_dashboards.py::test_cli_run_all
on both; the figure code runs on a pyplot that draws nothing
(``figures_off``; the port's figures are drawn in
tests/test_torch_analysis.py), so the manifests' names and the JSON and
Markdown files are compared.
Tolerances: equality throughout, 1e-6 relative on the log-spaced sweep.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from test_torch_analysis import figures_off

PORT_ROWS = ["cuda devices", "kernel build", "nerf pipeline", "sparse grid render", "octree render",
             "native C++ ops", "optional deps"]
REPEATED = ("sparse grid render", "octree render", "optional deps")


def parse_table(out: str) -> dict:
    """check_env's ``[PASS] name detail (sec)`` lines -> {name: (ok, detail)}."""
    rows = {}
    for line in out.splitlines():
        if line[:1] == "[":
            mark, rest = line[1:5], line[7:]
            name, detail = rest[:22].strip(), rest[23:].rsplit(" (", 1)[0]
            rows[name] = (mark == "PASS", detail)
    return rows


@pytest.fixture(scope="module")
def jax_rows():
    """{row name: detail} of JAX's check_env: every row's name in its
    order; the detail of the rows the port repeats at JAX's configuration,
    None for the rest (JAX's devices, jit, NeRF render and g++ build are
    not run)."""
    import jax

    from nerf_projects_tpu.cli import check_env as jce
    from nerf_projects_tpu.ops import grid as jgrid

    rows = {}

    def check(name, fn, results):
        rows[name] = fn() if name in REPEATED else None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jce, "check", check)
        mp.setattr(jgrid, "volume_render_grid", jax.jit(jgrid.volume_render_grid, static_argnums=(2,)))
        jce.main([])
    return rows


def test_check_env_on_the_host_is_green_and_follows_jax(jax_rows, capsys):
    from nerf_projects_tpu_torch.cli.check_env import main

    main(["--device", "cpu"])
    out = capsys.readouterr().out
    rows = parse_table(out)
    assert '"all_ok": true' in out and "FAIL" not in out
    assert list(rows) == PORT_ROWS
    assert list(jax_rows)[:2] == ["jax devices", "jit matmul"] and list(jax_rows)[2:] == PORT_ROWS[2:]
    assert all(ok for ok, _ in rows.values()), rows
    for name in REPEATED:
        assert rows[name][1] == jax_rows[name], name
    assert rows["kernel build"][1].startswith("plain (host)")
    assert rows["native C++ ops"][1] == "compiled"
    assert rows["cuda devices"][1].startswith("cpu;")


def test_check_env_without_a_card_fails_and_exits_1(monkeypatch, capsys):
    """No argument means the card: with none, the device rows FAIL and the
    run exits 1; nothing carries on on the host."""
    from nerf_projects_tpu_torch.cli.check_env import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit) as exit_:
        main([])
    assert exit_.value.code == 1
    out = capsys.readouterr().out
    rows = parse_table(out)
    assert '"all_ok": false' in out
    for name in ("cuda devices", "kernel build", "nerf pipeline", "sparse grid render", "octree render"):
        ok, detail = rows[name]
        assert not ok and "no CUDA device" in detail, (name, detail)


# -- the task manager (tests/test_task_manager.py on both packages) ---------


def both_task_managers():
    from nerf_projects_tpu.pipeline import task_manager as jtm
    from nerf_projects_tpu_torch.pipeline import task_manager as ttm

    return jtm, ttm


def test_expand_variables_matches_jax():
    jtm, ttm = both_task_managers()
    for spec in ({"lr": "loglin(1, 100, 3)"}, {"a": "lin(0, 1, 3)", "b": [1, 2]}, {"w": "log(0.5,8,5)"},
                 {"s": "plain", "t": ("x", "y")}, {}):
        want, got = jtm.expand_variables(spec), ttm.expand_variables(spec)
        assert [list(v) for v in got] == [list(v) for v in want]
        for g, w in zip(got, want):
            for k in w:
                if isinstance(w[k], float):
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-6)
                else:
                    assert g[k] == w[k]
    lrs = [v["lr"] for v in ttm.expand_variables({"lr": "loglin(1, 100, 3)"})]
    np.testing.assert_allclose(lrs, [1.0, 10.0, 100.0], rtol=1e-6)
    vals = ttm.expand_variables({"a": "lin(0, 1, 3)", "b": [1, 2]})
    assert len(vals) == 6 and {v["b"] for v in vals} == {1, 2}


def test_substitute_and_parse_stdout_match_jax():
    jtm, ttm = both_task_managers()
    for template, mapping in (("train.py {scene} --lr {lr}", {"scene": "lego", "lr": 0.1}),
                              ("{a}{a} {missing}", {"a": 3})):
        assert ttm.substitute(template, mapping) == jtm.substitute(template, mapping)
    assert ttm.substitute("train.py {scene} --lr {lr}", {"scene": "lego", "lr": 0.1}) == "train.py lego --lr 0.1"
    for text in ('done {"psnr": 31.25, "capacity": 1000}', "PSNR = 12.5\npsnr: 13.75", "nothing", '"test_psnr": 9.5'):
        assert ttm.parse_stdout_metrics(text) == jtm.parse_stdout_metrics(text)
    m = ttm.parse_stdout_metrics('done {"psnr": 31.25, "capacity": 1000}')
    assert m == {"psnr": 31.25, "capacity": 1000.0}


def test_runs_real_subprocesses_as_jax_does(tmp_path):
    """Two scenes from a string template, run serially by both packages and
    on the port's spawn pool of two workers: the same results, in order,
    and the same results file."""
    jtm, ttm = both_task_managers()
    spec = {"scenes": ["lego", "chair"],
            "tasks": [{"name": "echo", "cmd": f"{sys.executable} -c \"print('psnr: 25.0 for {{scene}}')\""}]}
    tasks = ttm.build_tasks_from_spec(spec)
    assert tasks == jtm.build_tasks_from_spec(spec) and len(tasks) == 2
    want = jtm.TaskManager(n_workers=1).run(tasks, results_path=str(tmp_path / "jax.txt"))
    got = ttm.TaskManager(n_workers=1).run(tasks, results_path=str(tmp_path / "port.txt"))
    pooled = ttm.TaskManager(n_workers=2).run(tasks, results_path=str(tmp_path / "pool.txt"))
    assert got == want == pooled
    assert all(r["returncode"] == 0 and r["metrics"]["psnr"] == 25.0 for r in got)
    text = (tmp_path / "jax.txt").read_text()
    assert (tmp_path / "port.txt").read_text() == text == (tmp_path / "pool.txt").read_text()
    assert len(text.splitlines()) == 2
    assert ttm.TaskManager().n_workers == max(1, torch.cuda.device_count())


def test_sweep_and_leaderboard_match_jax():
    jtm, ttm = both_task_managers()
    spec = {"tasks": [{"name": "sweep", "cmd": f"{sys.executable} -c \"print('psnr:', 10 * {{lr}})\""}],
            "variables": {"lr": [1.0, 3.0, 2.0]}}
    tasks = ttm.build_tasks_from_spec(spec)
    assert tasks == jtm.build_tasks_from_spec(spec)
    results = ttm.TaskManager(n_workers=1).run(tasks)
    assert results == jtm.TaskManager(n_workers=1).run(tasks)
    board = ttm.leaderboard(results)
    assert board == jtm.leaderboard(results)
    assert board[0][0] == 30.0 and "lr=3" in board[0][1]


def test_test_psnr_file_preferred_as_jax_does(tmp_path):
    jtm, ttm = both_task_managers()
    td = tmp_path / "run"
    td.mkdir()
    (td / "test_psnr.txt").write_text("42.5\n")
    tasks = [{"name": "t", "cmd": f"{sys.executable} -c \"print('psnr: 1.0')\"", "train_dir": str(td)},
             {"name": "slow", "cmd": f"{sys.executable} -c \"import time; time.sleep(5)\"", "timeout": 0.5}]
    got = ttm.TaskManager(n_workers=1).run(tasks)
    assert got == jtm.TaskManager(n_workers=1).run(tasks)
    assert got[0]["metrics"]["psnr"] == 42.5
    assert got[1] == {"name": "slow", "returncode": -1, "metrics": {}, "error": "timeout"}


# -- run_analysis (tests/test_dashboards.py::test_cli_run_all) -------------


def drums_logs(base):
    """tests/test_dashboards.py's make_experiment(base, "drums", seed=5),
    written by the port's MetricsLogger."""
    from nerf_projects_tpu_torch.obs.json_logger import MetricsLogger

    d = os.path.join(base, "drums")
    rng = np.random.default_rng(5)
    logger = MetricsLogger(d)
    for i in range(0, 50, 5):
        psnr = 15.0 + 10 * i / 50 + rng.normal(0, 0.2)
        logger.log_training_step(i, {"loss": float(np.exp(-i / 50) * 0.1), "psnr": float(psnr)}, 5e-4,
                                 memory_metrics={"device_memory_gb": 1.0 + i / 50},
                                 efficiency_indices={"memory_efficiency_index": float(psnr)})
    logger.log_evaluation_step(50, {"psnr": 25.5, "ssim": 0.93})
    logger.log_metrics(50, "extraction", {"psnr": 23.0, "capacity": 1e6})
    logger.log_metrics(51, "optimization", {"psnr": 24.5})
    logger.log_metrics(52, "compression", {"psnr": 24.2, "compression_ratio": 40.0, "storage_mb": 22.0})
    return d


def manifest_names(manifest, base):
    return ([(os.path.relpath(e["dir"], base), [os.path.basename(f) for f in e["figures"]])
             for e in manifest["per_experiment"]], [os.path.basename(f) for f in manifest.get("global", [])])


def test_run_analysis_cli_matches_jax(tmp_path, capsys):
    from nerf_projects_tpu.cli.run_analysis import main as jmain
    from nerf_projects_tpu_torch.cli.run_analysis import main

    drums_logs(str(tmp_path / "logs"))
    for side in ("jax", "port"):
        shutil.copytree(tmp_path / "logs", tmp_path / side / "exps")
    jbase, pbase = str(tmp_path / "jax" / "exps"), str(tmp_path / "port" / "exps")
    with figures_off():
        jmain([jbase, "--json"])
        want = json.loads(capsys.readouterr().out)
        main([pbase, "--json"])
        got = json.loads(capsys.readouterr().out)
    assert manifest_names(got, pbase) == manifest_names(want, jbase)
    assert got["per_experiment"][0]["figures"]
    for f in got["per_experiment"][0]["figures"] + got["global"]:
        assert os.path.exists(f), f
    for name in ("leaderboard.json", "leaderboard.md", "drums/efficiency_report.json"):
        assert (tmp_path / "port" / "exps" / name).read_text() == (tmp_path / "jax" / "exps" / name).read_text()

    with figures_off():
        main([pbase, "--experiment", "drums"])
    assert capsys.readouterr().out == "wrote 3 per-experiment figures + 0 global outputs\n"  # JAX's line


def test_host_tools_import_no_torch():
    """The data tools, the analysis and the task manager import no torch
    (the package inits load their names at first use), so each task of a
    sweep of them is a light process, as chip_smoke.py's tools phase
    needs."""
    import subprocess

    mods = ["cli.data_prep", "cli.view_data", "cli.run_analysis", "data.co3d", "data.converters",
            "obs.dashboards", "obs.memory_analysis", "pipeline.task_manager"]
    code = ("import sys\n" + "".join(f"import nerf_projects_tpu_torch.{m}\n" for m in mods)
            + "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "[]"
    from nerf_projects_tpu_torch import data, obs
    from nerf_projects_tpu_torch.data.synthetic import make_dataset
    from nerf_projects_tpu_torch.obs.metrics import compute_metrics

    assert data.make_dataset is make_dataset and obs.compute_metrics is compute_metrics
    with pytest.raises(AttributeError):
        data.no_such_name
