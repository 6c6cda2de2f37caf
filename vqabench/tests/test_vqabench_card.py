"""On the card: each cell at its configuration's widths on a small store
(``rehearse.card``), its control (the reference computed with TF32 on, in
the program's place) comes out not correct and the program correct.
Skips without a card."""

import pytest

from vqabench.tests.conftest import CELLS, rehearse


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("mode", ["program", "control"])
def test_control_fails_and_program_passes_on_the_card(cell, mode, cuda_card):
    result, lines = rehearse(cell, 20260419, mode=mode, device="cuda", seconds=0.5)
    assert result["correct"] == (mode == "program"), lines
