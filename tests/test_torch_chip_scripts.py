"""The card scripts' catalogues against the code they name (CPU): each
chip_mutants.py mutant's original text occurs exactly once in its file, so
a mutant cannot go stale when code moves, and the phases it must fail are
ones chip_mutants.py runs; every chip_smoke.py function that a
chip_paired.sh mode or a mutant phase calls exists."""
import ast
import inspect
import re
from pathlib import Path

import pytest

import chip_mutants
import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
PAIRED = (ROOT / "chip_paired.sh").read_text()
MODES = dict(re.findall(r'^\s*([\w+*]+)\)\n\s*phases="([^"]+)"', PAIRED, re.MULTILINE))


@pytest.mark.parametrize("label", list(chip_mutants.MUTANTS))
def test_mutant_original_occurs_once(label):
    path, old, new, phases = chip_mutants.MUTANTS[label]
    assert (ROOT / path).read_text().count(old) == 1, label
    assert old != new and phases


PHASES = re.findall(r'"(\w+)": lambda: c\.(\w+)\(', chip_mutants.PHASES)


@pytest.mark.parametrize("label", list(chip_mutants.MUTANTS))
def test_mutant_phases_are_runnable(label):
    """Each phase a mutant must fail is one chip_mutants.py can run."""
    phases = chip_mutants.MUTANTS[label][3]
    assert set(phases) <= {name for name, _ in PHASES}, label


def test_mutant_phases_call_existing_functions():
    assert PHASES
    for name, fn in PHASES:
        assert callable(getattr(chip_smoke, fn, None)), (name, fn)


def test_paired_modes_are_the_known_ones():
    assert set(MODES) == {"plenoxels", "plenoxels+train", "mlp", "*"}


@pytest.mark.parametrize("mode", ["plenoxels", "plenoxels+train", "mlp", "*"])
def test_paired_mode_calls_existing_phases(mode):
    names = re.findall(r"\b[cs]\.(\w+)\(", MODES[mode])
    assert names, mode
    for name in names:
        assert callable(getattr(chip_smoke, name, None)), (mode, name)


def test_chip_probes_refuse_without_a_card(monkeypatch):
    """chip_probes.py, like chip_smoke.py, exits non-zero with no card."""
    import chip_probes

    monkeypatch.setattr(chip_probes.torch.cuda, "is_available", lambda: False)
    assert chip_probes.main() == 1


def test_sparse_phase_is_callable_and_imports_only_the_port():
    """The row-sparse steps' phase exists, a mutant must fail it, and it
    (like the whole script) imports nothing of the JAX package."""
    fn = chip_smoke.phase_train_plenoxels_sparse
    assert callable(fn) and list(inspect.signature(fn).parameters) == ["dev", "card"]
    assert any("train_plenoxels_sparse" in m[3] for m in chip_mutants.MUTANTS.values())
    for node in ast.walk(ast.parse((ROOT / "chip_smoke.py").read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert not name.startswith("jax") and (name == "nerf_projects_tpu_torch"
                                                   or not name.startswith("nerf_projects_tpu")
                                                   or name.startswith("nerf_projects_tpu_torch.")), name
    src = inspect.getsource(fn)
    for used in ("train_step_tiles_sparse", "train_step_tiles_packed_touched", "touched_bricks", "check_waits",
                 "flag_touched=True", "train_plenoxels"):
        assert used in src, used


@pytest.mark.parametrize("name", ["phase_render_plenoxels_eval", "phase_train_plenoxels_bg"])
def test_eval_and_background_phases_are_callable_and_import_only_the_port(name):
    """The render CLI's per-ray routes' phase and the background and
    learned-basis steps' phase exist with the other phases' signature, a
    chip_mutants.py phase runs each, the top-K mutant must fail the render
    one, and neither imports anything of the JAX package."""
    fn = getattr(chip_smoke, name)
    assert callable(fn) and list(inspect.signature(fn).parameters) == ["dev", "card"]
    assert name[len("phase_"):] in {n for n, _ in PHASES}
    src = inspect.getsource(fn)
    for node in ast.walk(ast.parse(src)):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for mod in names:
            assert not mod.startswith("jax") and (not mod.startswith("nerf_projects_tpu")
                                                  or mod.startswith("nerf_projects_tpu_torch")), mod
    if name == "phase_render_plenoxels_eval":
        assert any(m[3] == ("render_plenoxels_eval",) and "largest=False" in m[2]
                   for m in chip_mutants.MUTANTS.values())
        for used in ("render_grid_image", "color_top_k", "make_render_cache", "build_occupancy", "torch.topk"):
            assert used in src, used
    else:
        for used in ("train_step_bg", "train_step_with_basis", "check_waits", "build_neighbor_links",
                     "ReferenceBackground", "timed_steps"):
            assert used in src, used


@pytest.mark.parametrize("name,used", [
    ("phase_train_nerf_loop", ("loop.train", "trainer_kwargs", "use_mega", "fern", "load_checkpoint",
                               "make_draw", "check_waits", "scan_steps", "compute_metrics", "render_image",
                               "hold_step", "make_trainer")),
    ("phase_train_nerf_sh_cli", ("train_main", "evaluate", "use_fused_trunk=True", "save_output=False",
                                 "render_image_sh", "fused_sh_fwd.launches", "fused_sh_bwd.launches")),
    ("phase_plenoctree", ("train_main", "cmd_extract", "cmd_evaluate", "--fast", "finetune_fast",
                          "OctreeFinetuner", "cmd_compress", "cmd_compressed_eval", "gen_mesh.main", "to_octree",
                          "octree_to_grid", "plain_sh", "octree_march_steps", "fused_sh_fwd.launches",
                          "tile_march_fwd.launches", "tile_march_bwd.launches")),
])
def test_loop_and_sh_cli_phases_are_callable_and_import_only_the_port(name, used):
    """The training loop's phase, the NeRF-SH CLIs' phase and the
    PlenOctree phase exist with the other phases' signature (the last two
    also take the run directory main keeps for both), chip_mutants.py runs
    each, a mutant must fail each, and none imports anything of the JAX
    package."""
    fn = getattr(chip_smoke, name)
    assert callable(fn) and list(inspect.signature(fn).parameters)[:2] == ["dev", "card"]
    phase = name[len("phase_"):]
    assert phase in {n for n, _ in PHASES}
    assert any(m[3] == (phase,) for m in chip_mutants.MUTANTS.values())
    src = inspect.getsource(fn)
    for node in ast.walk(ast.parse(src)):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for mod in names:
            assert not mod.startswith("jax") and (not mod.startswith("nerf_projects_tpu")
                                                  or mod.startswith("nerf_projects_tpu_torch")), mod
    for u in used:
        assert u in src, u
    assert name + "(dev, card" in inspect.getsource(chip_smoke.main)


def _port_imports_only(src):
    for node in ast.walk(ast.parse(src)):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for mod in names:
            assert not mod.startswith("jax") and (not mod.startswith("nerf_projects_tpu")
                                                  or mod.startswith("nerf_projects_tpu_torch")), mod


@pytest.mark.parametrize("name,used", [
    ("phase_parallel", ("init_distributed", '"nccl"', "make_mesh", "destroy_process_group", "check_waits",
                        "run_ranks", "chip_smoke:parallel_rank", '"gloo"', "device_count", "render_image",
                        "grad_bounds", "own_cells", "cells_agree", "one_bytes")),
    ("parallel_rank", ("make_mesh", "scan_steps", "apply_grads", "render_rays_sharded", "shard_state_rows",
                       "train_step_tiles_packed_touched", "mesh=mesh", "state_bytes", "all_gather")),
])
def test_parallel_phase_is_callable_and_imports_only_the_port(name, used):
    """The data-parallel phase and what its ranks run exist, chip_mutants.py
    runs the phase, both of its mutants (K2's global count, the cells'
    all_gather) must fail it, main runs it, and neither imports anything of
    the JAX package."""
    fn = getattr(chip_smoke, name)
    assert callable(fn)
    src = inspect.getsource(fn)
    _port_imports_only(src)
    for u in used:
        assert u in src, u
    if name == "phase_parallel":
        assert list(inspect.signature(fn).parameters) == ["dev", "card"]
        assert "parallel" in {n for n, _ in PHASES}
        musts = [m for m in chip_mutants.MUTANTS.values() if m[3] == ("parallel",)]
        assert {m[0] for m in musts} == {"nerf_projects_tpu_torch/train/nerf_trainer.py",
                                         "nerf_projects_tpu_torch/train/plenoxels_sparse.py"}
        assert "phase_parallel(dev, card)" in inspect.getsource(chip_smoke.main)
    else:
        assert list(inspect.signature(fn).parameters) == []


def test_gen_video_step_of_the_plenoctree_phase():
    """The PlenOctree phase drives gen_video's renderers of all three kinds
    and holds the grid's frames against render_grid_image."""
    src = inspect.getsource(chip_smoke.phase_plenoctree)
    for u in ("gen_video.make_renderer", '("grid", grid_path)', '("octree", tree_path)', '("nerf_sh", run_dir)',
              "render_grid_image(", "torch.isfinite"):
        assert u in src, u
