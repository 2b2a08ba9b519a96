"""The control: the reference in the program's place with one guarantee
broken must come out not correct; the float32 control reads as the
reference does at these weights (PERF.md gives why)."""

import pytest
import torch

from psabench import control

CELLS = ("single.long_seq2", "batch.long_rows")
MIX = {"seq1_len": 5000, "seq2_len": 1500}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_broken_tie_order_is_refused(cell, seed):
    res = control.run_control(cell, seed, "last_position",
                              torch.device("cpu"), MIX)
    assert res["correct"] is False
    assert res["wrong_answers"] == res["checked"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_float32_totals_are_exact_at_integer_weights(cell):
    res = control.run_control(cell, 4, "float32", torch.device("cpu"), MIX)
    assert res["wrong_answers"] == 0 and res["correct"] is True
