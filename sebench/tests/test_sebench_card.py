"""On the card, at each cell's own size: the control (the program's own
bf16 path in place of the stated precision) comes out not correct on
three seeds.  ``correct`` means every number compared is within its
limit, so a control that passed would show a limit too loose."""

import time

import pytest

from sebench import harness

CELLS = ["cmgan-serve-batch", "cmgan-serve-single", "scpgan-train-gan"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3_000_000_011, 3_000_000_012, 3_000_000_013])
def test_control_is_not_correct(card, cell, seed):
    result = harness.run_cell(cell, seed, 3.0, False, t0=time.perf_counter(),
                              spec_path=harness.ROOT.parent / "BENCHMARK.json",
                              overrides={"params": {"precision": "bf16"}})
    assert result["correct"] is False, result["checks"]
