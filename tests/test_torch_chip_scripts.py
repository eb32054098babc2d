"""The card scripts' catalogues against the code they name (CPU): each
chip_mutants.py mutant's original text occurs exactly once in its file, so
a mutant cannot go stale when code moves; every chip_smoke.py function
that a chip_paired.sh mode calls exists."""
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


def test_paired_modes_are_the_known_ones():
    assert set(MODES) == {"plenoxels", "plenoxels+train", "mlp", "*"}


@pytest.mark.parametrize("mode", ["plenoxels", "plenoxels+train", "mlp", "*"])
def test_paired_mode_calls_existing_phases(mode):
    names = re.findall(r"\b[cs]\.(\w+)\(", MODES[mode])
    assert names, mode
    for name in names:
        assert callable(getattr(chip_smoke, name, None)), (mode, name)
