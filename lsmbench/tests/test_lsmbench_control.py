"""The control of each cell's comparison (the reference one precision
lower in the program's place) comes out as not correct, at a size a test
run holds; on the card, ``lsmbench/control.py`` runs it at the cells'
own sizes."""
import pytest

from lsmbench import spec
from lsmbench.control import control
from lsmbench.harness import _merge
from lsmbench_helpers import CELLS, SEED, SMALL


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, SEED + 1, 7])
def test_control_is_not_correct(cell, seed):
    c = spec.load_cell(cell)
    c.config = _merge(c.config, SMALL["config"])
    c.workload = _merge(c.workload, SMALL["workload"])
    checks = control(c, seed, "cpu")
    assert not all(ch.ok for ch in checks), [(ch.name, ch.value)
                                              for ch in checks]
    by = {ch.name: ch for ch in checks}
    assert by["props_differing"].value > 0


@pytest.mark.cuda
def test_control_on_the_card_at_the_analytics_cells_size(cuda_device):
    c = spec.load_cell("g500-s22.analytics")
    checks = control(c, SEED, cuda_device)
    assert not all(ch.ok for ch in checks)
