"""The control on the card, at a size a test run holds: the reference computed
in float32 with TF32 matrix products, put in the program's place, fails the
cell's limits, and the program passes them. TF32 exists only on the card, so
these tests skip elsewhere; the cell-size readings come from
``portbench/control.py`` (``PERF.md`` gives them).

    python -m pytest portbench/tests -q
"""

import pytest
import torch

from portbench.control import readings
from portbench.harness import load_cell

SIZES = {
    "lewellen.main": {"n_firms": 6000, "n_months": 300},
    "lewellen.sweep": {"n_firms": 6000, "n_months": 300},
    "ghz.grid": {"n_firms": 6000, "n_months": 300, "n_chars": 94},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 matrix products exist only there")


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_fails_where_the_program_passes(card, name):
    _, _, cell, _ = load_cell(name)
    limits = cell["limits"]
    row = readings(name, 2**31 + 77, True, device="cuda", sizes=SIZES[name])
    assert {k: row["program"][k] for k in limits if row["program"][k] > limits[k]} == {}
    assert [k for k in limits if row["control"][k] > limits[k]], row["control"]
