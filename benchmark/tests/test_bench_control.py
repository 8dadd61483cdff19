"""The control fails the check (on a card, at each cell's own size): the
plain reference in float32 with every stage's result rounded to TF32 and
TF32 matrix products, put in the program's place, comes out not correct
on three seeds. `benchmark.harness.calibrate` prints the readings."""

import pytest

from benchmark.harness import calibrate, cell, check, traffic
from benchmark.tests.conftest import ROOT

CELLS = [w["name"] for w in cell.load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
def test_control_is_not_correct(card, workload, seed):
    c = cell.load(workload, ROOT)
    pool = traffic.make_pool(c.mix, c.config, seed)
    blocks = calibrate.drawn_blocks(len(pool), c.mix["check_blocks"], seed)
    outs = [(i, calibrate.control_outputs(pool[i], c.config, card)) for i in blocks]
    ok, shown = check.verdict(check.numbers(outs, pool, c.config, c.mix, seed, card), c.limits)
    assert not ok, shown
