"""On the card: each cell at its configuration's widths on a small store,
its control (the reference computed with TF32 on, in the program's place)
comes out not correct and the program correct.  Skips without a card."""

import pytest

from vqabench.tests.conftest import rehearse

STORES = {
    "arch1.train": ({}, {"traffic": {"questions": 5000, "images": 1000, "steps_per_dispatch": 2}}),
    "text_ae.train": ({"corpus_sentences": 20000},
                      {"traffic": {"rows": 20000, "steps_per_dispatch": 2}}),
    "arch1.eval": ({}, {"traffic": {"questions": 20000, "images": 4000}}),
    "text_ae.val": ({}, {"traffic": {"rows": 5000}}),
}


@pytest.mark.card
@pytest.mark.parametrize("cell", list(STORES))
@pytest.mark.parametrize("mode", ["program", "control"])
def test_control_fails_and_program_passes_on_the_card(cell, mode, cuda_card):
    config, traffic = STORES[cell]
    result, lines = rehearse(cell, 20260419, mode=mode, device="cuda", config=config,
                             cell=traffic, seconds=0.5)
    assert result["correct"] == (mode == "program"), lines
