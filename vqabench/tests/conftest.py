"""Shared set-up of the benchmark's own tests.

Tests that need a CUDA card carry the ``card`` marker and take the
``cuda_card`` fixture, which skips them where there is none; the decision
is made inside the fixture, never while a module is imported.  On the card:

    python3 -m pytest vqabench/tests -q -m card
"""

import time

import pytest
import torch

from vqabench import harness

# the cells at a size a CPU test holds: every width cut, the traffic small
SMALL_CONFIG = {
    "arch1": {"vocab_size": 50, "input_encoding_size": 8, "rnn_size": 16, "nhimage": 32,
              "common_embedding_size": 24, "num_output": 10},
    "text_ae": {"vocab_size": 60, "input_encoding_size": 16, "rnn_size": 16,
                "corpus_sentences": 400},
}
SMALL_CELL = {
    "arch1.train": {"traffic": {"questions": 300, "images": 40, "answers": 10, "batch_size": 20,
                                "steps_per_dispatch": 2}},
    "arch1.eval": {"traffic": {"questions": 130, "images": 30, "answers": 10, "mc_choices": 5,
                               "batch_size": 20}},
    "text_ae.train": {"traffic": {"rows": 400, "batch_size": 20, "steps_per_dispatch": 2}},
    "text_ae.val": {"traffic": {"rows": 100, "batch_size": 20}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the check runs on the card")
    return torch.device("cuda")


@pytest.fixture
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rehearse(workload, seed=20260417, *, trace=False, mode="program", device="cpu",
             config=None, cell=None, seconds=0.2):
    """One run of ``workload`` through the harness at the small size (or
    the overrides given), skipping the harness's look for a card."""
    name = workload.split(".")[0]
    overrides = {"config": SMALL_CONFIG[name] if config is None else config,
                 "cell": SMALL_CELL[workload] if cell is None else cell}
    return harness.run(workload, seed, seconds, trace, t_start=time.perf_counter(),
                       device=device, overrides=overrides, mode=mode)
