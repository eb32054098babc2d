"""The port's log analysis (``obs/analysis.py``), memory analysis
(``obs/memory_analysis.py``) and dashboards (``obs/dashboards.py``) against
the JAX package's, on the same logs.

The logs are written once (the port's MetricsLogger, the schema of both
packages) and copied, one copy per package, under directories of the same
names. Mirrored: tests/test_obs.py::TestAnalysis and
tests/test_dashboards.py. Compared: the numbers the figures and reports
are built from (experiment_summary, extract_pipeline_stages,
efficiency_trends, leaderboard, MemoryAnalyzer's statistics and
compare_phases) and the files both write (JSON, Markdown, the HTML report
with its file sizes masked) equal; the manifests' figure names equal. In
those comparisons both packages run their figure code on a pyplot that
draws nothing (``figures_off``: mocked axes, savefig writing an empty
file; ``pixels_off`` where a module imports pyplot itself), since drawing
is nearly all of a figure's time; the port draws every kind of figure for
real once, on one experiment, and each PNG must be non-empty
(``test_run_all_draws_every_figure``). The dashboards' comparison is
shared through the module fixture ``dash``.
"""
import contextlib
import json
import os
import re
import shutil
from unittest import mock

import numpy as np
import pytest

from nerf_projects_tpu_torch.obs import analysis, dashboards
from nerf_projects_tpu_torch.obs.json_logger import MetricsLogger


@contextlib.contextmanager
def pixels_off():
    """Inside, a figure's savefig writes an empty file instead of drawing."""
    import matplotlib.figure

    def savefig(self, fname, *args, **kwargs):
        open(fname, "wb").close()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(matplotlib.figure.Figure, "savefig", savefig)
        yield


class NoDrawPyplot:
    """The pyplot calls of the analysis figures, drawing nothing:
    ``subplots`` returns a mock figure and mock axes in matplotlib's shapes
    (one axes, or an array squeezed as matplotlib squeezes it), and a
    figure's ``savefig`` writes an empty file."""

    @staticmethod
    def subplots(nrows=1, ncols=1, **kwargs):
        fig = mock.MagicMock()
        fig.savefig.side_effect = lambda path, *a, **k: open(path, "wb").close()
        if nrows == ncols == 1:
            return fig, mock.MagicMock()
        axes = np.empty((nrows, ncols), object)
        for idx in np.ndindex(axes.shape):
            axes[idx] = mock.MagicMock()
        return fig, axes.squeeze() if 1 in (nrows, ncols) else axes

    @staticmethod
    def close(fig):
        pass


@contextlib.contextmanager
def figures_off():
    """Inside, both packages' obs/analysis.py and obs/dashboards.py figures
    go to NoDrawPyplot: their data and control flow run, nothing is drawn."""
    from nerf_projects_tpu.obs import analysis as janalysis
    from nerf_projects_tpu.obs import dashboards as jdashboards

    with pytest.MonkeyPatch.context() as mp:
        for mod in (analysis, janalysis):
            mp.setattr(mod, "_plt", NoDrawPyplot)
        for mod in (dashboards, jdashboards):
            mp.setattr(mod, "apply_theme", NoDrawPyplot)
        yield


def make_experiment(base, name, *, n_steps=50, psnr0=15.0, seed=0):
    """tests/test_dashboards.py's make_experiment (with the pipeline's stages)."""
    d = os.path.join(base, name)
    rng = np.random.default_rng(seed)
    logger = MetricsLogger(d)
    for i in range(0, n_steps, 5):
        psnr = psnr0 + 10 * i / n_steps + rng.normal(0, 0.2)
        logger.log_training_step(i, {"loss": float(np.exp(-i / n_steps) * 0.1), "psnr": float(psnr)}, 5e-4,
                                 memory_metrics={"device_memory_gb": 1.0 + i / n_steps},
                                 efficiency_indices={"memory_efficiency_index": float(psnr)})
    logger.log_evaluation_step(n_steps, {"psnr": psnr0 + 10.5, "ssim": 0.93})
    logger.log_metrics(n_steps, "extraction", {"psnr": psnr0 + 8.0, "capacity": 1e6})
    logger.log_metrics(n_steps + 1, "optimization", {"psnr": psnr0 + 9.5})
    logger.log_metrics(n_steps + 2, "compression", {"psnr": psnr0 + 9.2, "compression_ratio": 40.0,
                                                    "storage_mb": 22.0})
    return d


def make_enhanced(base, name="hotdog"):
    """tests/test_dashboards.py::test_enhanced_scene_dashboard's log: SSIM,
    LPIPS, peak memory and two efficiency indices."""
    d = os.path.join(base, name)
    rng = np.random.default_rng(7)
    logger = MetricsLogger(d)
    for i in range(0, 60, 5):
        psnr = 16.0 + 12 * i / 60 + rng.normal(0, 0.1)
        logger.log_training_step(
            i, {"psnr": float(psnr), "ssim": 0.8 + 0.15 * i / 60, "lpips": 0.3 - 0.2 * i / 60}, 5e-4,
            memory_metrics={"device_memory_gb": 1.0 + 0.5 * i / 60, "device_peak_memory_gb": 2.0 + 0.5 * i / 60},
            efficiency_indices={"memory_efficiency_index": float(psnr) / 2.0,
                                "quality_memory_tradeoff": float(psnr) * 0.8 / 2.0})
    return d


def two_copies(tmp, make):
    """make(base) writes logs; returns the (jax, port) copies of them."""
    make(os.path.join(tmp, "logs", "exps"))
    for side in ("jax", "port"):
        shutil.copytree(os.path.join(tmp, "logs"), os.path.join(tmp, side))
    return os.path.join(tmp, "jax", "exps"), os.path.join(tmp, "port", "exps")


def figure_names(manifest, base):
    return ([(os.path.relpath(e["dir"], base), [os.path.basename(f) for f in e["figures"]])
             for e in manifest["per_experiment"]], [os.path.basename(f) for f in manifest["global"]])


def masked_sizes(html: str) -> str:
    return re.sub(r"\(\d+\.\d KB\)", "(KB)", html)


def same_text(jbase, pbase, name):
    with open(os.path.join(jbase, name)) as a, open(os.path.join(pbase, name)) as b:
        assert a.read() == b.read(), name


@pytest.fixture(scope="module")
def dash(tmp_path_factory):
    """run_all of both packages over lego (the pipeline's stages) and
    hotdog (the enhanced panels), figures not drawn: (jax base, port base,
    jax manifest, port manifest)."""
    from nerf_projects_tpu.obs.dashboards import run_all as jrun_all

    tmp = str(tmp_path_factory.mktemp("dash"))
    jbase, pbase = two_copies(tmp, lambda b: (make_experiment(b, "lego", seed=1), make_enhanced(b)))
    with figures_off():
        want = jrun_all(jbase)
        got = dashboards.run_all(pbase)
    return jbase, pbase, want, got


# -- obs/analysis.py (tests/test_obs.py::TestAnalysis) ---------------------


def fake_experiment(exp_dir, csv_only=False):
    """TestAnalysis's experiment: five training_log rows, a testset, and a
    MetricsLogger training entry with memory; with ``csv_only`` the rows
    are in training_log.csv instead, and nothing else."""
    os.makedirs(exp_dir, exist_ok=True)
    rows = [{"step": (i + 1) * 100, "loss": 0.1 / (i + 1), "psnr": 20 + i, "rays_per_sec": 1000.0 + i}
            for i in range(5)]
    if csv_only:
        with open(os.path.join(exp_dir, "training_log.csv"), "w") as f:
            f.write("step,loss,psnr,rays_per_sec\n")
            f.writelines(f"{r['step']},{r['loss']},{r['psnr']},{r['rays_per_sec']}\n" for r in rows)
        return
    with open(os.path.join(exp_dir, "training_log.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    os.makedirs(os.path.join(exp_dir, "testset_000500"))
    with open(os.path.join(exp_dir, "testset_000500", "metrics.json"), "w") as f:
        json.dump({"mean": {"psnr": 24.5, "ssim": 0.8}}, f)
    MetricsLogger(exp_dir, clean_existing=False).log_training_step(
        100, {"loss": 0.1, "psnr": 20}, 1e-3, memory_metrics={"device_memory_gb": 1.0, "process_rss_gb": 2.0})


def test_curves_and_summary_match_jax(tmp_path):
    from nerf_projects_tpu.obs import analysis as janalysis

    def make(base):
        fake_experiment(os.path.join(base, "exp_a"))
        fake_experiment(os.path.join(base, "exp_b"))
        fake_experiment(os.path.join(base, "exp_c"), csv_only=True)

    jbase, pbase = two_copies(str(tmp_path), make)
    for name in ("exp_a", "exp_c"):
        j, p = os.path.join(jbase, name), os.path.join(pbase, name)
        assert analysis.load_training_log(p) == janalysis.load_training_log(j)
        assert analysis.load_metrics_log(p) == janalysis.load_metrics_log(j)
        assert analysis.experiment_summary(p) == janalysis.experiment_summary(j)
    exp = os.path.join(pbase, "exp_a")
    png = analysis.plot_training_curves(exp)
    assert png == os.path.join(exp, "training_curves.png") and os.path.getsize(png) > 0
    row = analysis.experiment_summary(exp)
    assert row["final_train_psnr"] == 24 and row["test_psnr"] == 24.5
    assert [r["psnr"] for r in analysis.load_training_log(os.path.join(pbase, "exp_c"))] == [20.0, 21.0, 22.0, 23.0,
                                                                                              24.0]
    with figures_off():
        want = janalysis.analyze_all_experiments(jbase)
        rows = analysis.analyze_all_experiments(pbase)
    assert rows == want and len(rows) == 2
    same_text(jbase, pbase, "comparison.json")
    for name in ("exp_a", "exp_b"):
        for fig in ("training_curves.png", "memory_trends.png"):
            assert os.path.exists(os.path.join(pbase, name, fig))
    assert analysis.plot_training_curves(os.path.join(pbase, "nothing")) is None


# -- obs/dashboards.py (tests/test_dashboards.py) --------------------------


def test_run_all_emits_full_set_as_jax_does(dash):
    jbase, pbase, want, got = dash
    assert figure_names(got, pbase) == figure_names(want, jbase)
    assert len(got["per_experiment"]) == 2
    names = {os.path.relpath(e["dir"], pbase): {os.path.basename(f) for f in e["figures"]}
             for e in got["per_experiment"]}
    assert {"scene_dashboard.png", "efficiency_trends.png", "training_curves.png"} <= names["lego"]
    assert os.path.exists(os.path.join(pbase, "cross_experiment.png"))
    for name in ("leaderboard.json", "leaderboard.md", "lego/efficiency_report.json"):
        same_text(jbase, pbase, name)
    lb = json.load(open(os.path.join(pbase, "leaderboard.json")))
    # ranked by test PSNR, else the last train PSNR from training_log.jsonl:
    # hotdog has neither (its log is metrics_log.json alone), so it ranks last
    assert [r["experiment"] for r in lb] == ["lego", "hotdog"]
    report = os.path.join(pbase, "results_report.html")
    assert report in got["global"]
    html = open(report).read()
    assert masked_sizes(html) == masked_sizes(open(os.path.join(jbase, "results_report.html")).read())
    assert "lego" in html and "hotdog" in html and "scene_dashboard.png" in html
    assert "<table>" in html and "<details>" in html


def test_run_all_draws_every_figure(tmp_path):
    """The port's run_all over hotdog's log draws every kind of figure of
    obs/analysis.py and obs/dashboards.py for real: none is empty."""
    base = str(tmp_path / "exps")
    make_enhanced(base)
    got = dashboards.run_all(base)
    figs = got["per_experiment"][0]["figures"] + [g for g in got["global"] if g.endswith(".png")]
    assert sorted(os.path.basename(f) for f in figs) == sorted([
        "training_curves.png", "memory_trends.png", "scene_dashboard.png", "stage_timing.png",
        "efficiency_trends.png", "memory_analysis.png", "efficiency_comparison.png", "quality_detailed.png",
        "training_progression.png", "cross_experiment.png"])
    for f in figs:
        assert os.path.getsize(f) > 0, f


def test_pipeline_stages_and_trends_match_jax(dash):
    from nerf_projects_tpu.obs import analysis as janalysis
    from nerf_projects_tpu.obs import dashboards as jdash

    jbase, pbase, _, _ = dash
    for name in ("lego", "hotdog"):
        j, p = os.path.join(jbase, name), os.path.join(pbase, name)
        assert dashboards.extract_pipeline_stages(p) == jdash.extract_pipeline_stages(j)
        assert dashboards.efficiency_trends(p) == jdash.efficiency_trends(j)
        assert analysis.experiment_summary(p) == janalysis.experiment_summary(j)
    stages = dashboards.extract_pipeline_stages(os.path.join(pbase, "lego"))
    assert set(stages) >= {"training", "extraction", "optimization", "compression", "evaluation"}
    assert stages["training"]["best_psnr"] is not None
    assert stages["compression"]["extras"]["compression_ratio"] == 40.0


def test_efficiency_report_as_jax_does(dash):
    _, pbase, _, _ = dash
    rep = json.load(open(os.path.join(pbase, "lego", "efficiency_report.json")))
    assert "memory_efficiency_index" in rep["final"] and rep["n_samples"] == 10  # the training steps


def test_enhanced_scene_dashboard_as_jax_does(dash):
    jbase, pbase, want, got = dash
    figs = [e for e in got["per_experiment"] if e["dir"].endswith("hotdog")][0]["figures"]
    enhanced = {os.path.basename(f) for f in figs if os.sep + "enhanced_analysis" + os.sep in f}
    assert enhanced == {"memory_analysis.png", "efficiency_comparison.png", "quality_detailed.png",
                        "training_progression.png"}


def test_run_all_reports_a_broken_log_and_goes_on_as_jax_does(tmp_path, capsys):
    """A training log without steps: plot_training_curves raises, run_all
    prints the failure (JAX's per-figure ``except Exception``) and draws
    the rest."""
    from nerf_projects_tpu.obs.dashboards import run_all as jrun_all

    def make(base):
        d = os.path.join(base, "broken")
        os.makedirs(d)
        with open(os.path.join(d, "training_log.jsonl"), "w") as f:
            f.writelines(json.dumps({"loss": 0.1 / (i + 1), "psnr": 20.0 + i}) + "\n" for i in range(4))

    jbase, pbase = two_copies(str(tmp_path), make)
    with figures_off():
        want = jrun_all(jbase)
        want_out = capsys.readouterr().out.replace(jbase, "BASE")
        got = dashboards.run_all(pbase)
        got_out = capsys.readouterr().out.replace(pbase, "BASE")
    assert got_out == want_out == "[analysis] plot_training_curves failed for BASE/broken: 'step'\n"
    assert figure_names(got, pbase) == figure_names(want, jbase)
    assert [os.path.basename(f) for f in got["per_experiment"][0]["figures"]] == ["scene_dashboard.png"]


def test_handles_empty_dir_as_jax_does(tmp_path):
    from nerf_projects_tpu.obs.dashboards import run_all as jrun_all

    jbase, pbase = two_copies(str(tmp_path), os.makedirs)
    want, got = jrun_all(jbase), dashboards.run_all(pbase)
    assert got["per_experiment"] == want["per_experiment"] == []
    assert figure_names(got, pbase) == figure_names(want, jbase)
    same_text(jbase, pbase, "results_report.html")


# -- obs/memory_analysis.py -------------------------------------------------


def test_memory_analysis_matches_jax(tmp_path):
    """analyze_directory over lego's and hotdog's logs: the statistics of
    every phase, compare_phases and the report equal; the port's figure
    non-empty."""
    import pandas as pd

    from nerf_projects_tpu.obs import memory_analysis as jma
    from nerf_projects_tpu_torch.obs import memory_analysis as ma

    jbase, pbase = two_copies(str(tmp_path), lambda b: (make_experiment(b, "lego", seed=1), make_enhanced(b)))
    with pixels_off():
        want = jma.analyze_directory(jbase, os.path.join(jbase, "out"))
    got = ma.analyze_directory(pbase, os.path.join(pbase, "out"))
    pd.testing.assert_frame_equal(got.to_dataframe(), want.to_dataframe())
    for phase in (None, "training", "evaluation", "extraction"):
        assert got.analyze_memory_efficiency(phase) == want.analyze_memory_efficiency(phase)
    cmp = got.compare_phases()
    pd.testing.assert_frame_equal(cmp, want.compare_phases())
    assert set(cmp.index) == {"training", "evaluation", "extraction", "optimization", "compression"}
    stats = got.analyze_memory_efficiency("training")
    assert stats["max_device_memory_gb"] == pytest.approx(1.9)  # lego at step 45
    with open(os.path.join(jbase, "out", "memory_report.md")) as a, open(os.path.join(pbase, "out",
                                                                                      "memory_report.md")) as b:
        assert b.read().replace(pbase, "BASE") == a.read().replace(jbase, "BASE")
    assert os.path.getsize(os.path.join(pbase, "out", "memory_trends.png")) > 0
    assert ma.MemoryAnalyzer([os.path.join(pbase, "missing.json")]).analyze_memory_efficiency() == {}
