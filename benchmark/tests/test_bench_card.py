"""The kernels on the card against the reference, and the control, at a
size a test holds (the cells' own sizes run through benchmark.readings)."""

import pytest

from benchmark import run


@pytest.mark.card
@pytest.mark.parametrize("precision,correct", [("fp32", True), ("bf16", False)])
def test_backlog_on_the_card(card, small_cell, precision, correct):
    small_cell(1024, engine={"pallas_precision": precision})
    rc, line, notes = run.run_cell("stress-5k.backlog", 2**31 + 23, 3.0,
                                   False, device=card)
    assert rc == 0, notes
    assert line["correct"] is correct, line["checks"]
