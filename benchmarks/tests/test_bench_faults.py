"""The comparison catches what it is there to catch: each cell's control and
each fault the cell can have, planted under the timed path
(``benchmarks/faults.py``), turn ``correct`` false in a whole run of the
harness, while the program as it ships passes.

At the CPU's tiny sizes the errors against the truth are larger than at the
cell's size, so these runs are judged by limits at three times what the
program as it ships reads on the same inputs (the cells' own limits are set
from readings on the card: PERF.md). The TF32 witness runs on the card only.
"""

from __future__ import annotations

import pytest

from benchmarks import faults, run
from benchmarks.harness import cell as cell_mod
from benchmarks.tests.conftest import tiny_cell

BENCH = cell_mod.benchmark()
CASES = {"gopro9_ds3.calibrate": [v for v in faults.CALIBRATE if v != "tf32"],
         "gopro9_ds3.detect": list(faults.DETECT),
         "gopro9_ds3.batch4": [v for v in faults.BATCH if v != "tf32"]}
_sound = {}


def _run(name, variant, limits=None):
    cell = tiny_cell(name, variant=variant)
    if limits is not None:
        cell.limits = limits
    return cell, run.execute(cell, BENCH, 0.0, False, run.time.perf_counter())


def _tiny_limits(name):
    if name not in _sound:
        cell, res = _run(name, "")
        values = {k: c["value"] for k, c in res["compared"].items()}
        _sound[name] = {k: 3.0 * v for k, v in values.items()}
    return _sound[name]


@pytest.mark.parametrize("name", list(CASES))
def test_the_program_as_it_ships_passes_its_tiny_limits(name):
    _, sound = _run(name, "", _tiny_limits(name))
    assert sound["correct"], sound["compared"]


@pytest.mark.parametrize("name,variant", [(n, v) for n, vs in CASES.items() for v in vs])
def test_control_and_faults_turn_correct_false(name, variant):
    _, res = _run(name, variant, _tiny_limits(name))
    assert not res["correct"], res["compared"]


@pytest.mark.cuda
def test_tf32_witness_on_the_card(card):
    """The program with TF32 products on, at the tiny calibrate size on the
    card: it has to run; whether it fails is read at the cell's size."""
    cell = tiny_cell("gopro9_ds3.calibrate", variant="tf32")
    cell.device = card
    res = run.execute(cell, BENCH, 0.0, False, run.time.perf_counter())
    assert res["attempted"] >= 1
