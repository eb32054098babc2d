"""The port covers the JAX package, file by file and name by name (CPU,
parsing only): every ``.py`` file of ``nerf_projects_tpu/`` outside
``ops/pallas/`` has a file at the same path under
``nerf_projects_tpu_torch/``, and every public top-level name that the JAX
file defines, and every public method of its classes, is bound in the port
file (defined, assigned or imported there) or is one of NOT_PORTED, each of
which ROADMAP.md's "Not ported, by decision" names. NOT_PORTED must be
exactly what is missing, so an entry goes stale when its name is ported.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "nerf_projects_tpu", ROOT / "nerf_projects_tpu_torch"

NOT_PORTED = {
    "models/nerf_sh.py": {"NeRFSHModel.setup"},  # flax's constructor hook; the port's __init__ builds the modules
    "models/octree.py": {"PlenOctree.tree_flatten", "PlenOctree.tree_unflatten"},  # JAX pytree hooks
    "models/sparse_grid.py": {"SparseGrid.tree_flatten", "SparseGrid.tree_unflatten"},
    "ops/brick_grid.py": {"gather_windows", "BrickGrid.tree_flatten", "BrickGrid.tree_unflatten"},
    "parallel/mesh.py": {"batch_sharding", "replicated_sharding"},  # JAX NamedShardings; shard_rays / replicate
    "parallel/render.py": {"host_offset_key"},  # a JAX key fold; host_offset_generator
    "utils/native.py": {"available"},  # chooses a fallback; the port's host ops build or raise
}


def jax_files():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py") if p.relative_to(JAX).parts[:2] != ("ops", "pallas"))


def defined(tree: ast.Module) -> set:
    """Public names a module defines at its top level, and Class.method for
    the public methods of its classes."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{b.name}" for b in node.body if isinstance(b, ast.FunctionDef)}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not any(part.startswith("_") for part in n.split("."))}


def bound(tree: ast.Module) -> set:
    """What a module binds: its definitions and every name it imports."""
    out = defined(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def test_every_jax_file_has_a_port_file():
    missing = [f for f in jax_files() if not (PORT / f).is_file()]
    assert not missing, missing


@pytest.mark.parametrize("rel", jax_files())
def test_every_public_name_is_bound_or_not_ported_by_decision(rel):
    jax_names = defined(ast.parse((JAX / rel).read_text()))
    port_names = bound(ast.parse((PORT / rel).read_text()))
    assert sorted(jax_names - port_names) == sorted(NOT_PORTED.get(rel, ()))


def test_roadmap_names_every_name_not_ported():
    text = (ROOT / "ROADMAP.md").read_text()
    section = text[text.index("**Not ported, by decision.**"):]
    section = section[:section.index("\n### ")]
    for rel, names in NOT_PORTED.items():
        for name in names:
            assert f"`{rel}::{name}`" in section, (rel, name)
