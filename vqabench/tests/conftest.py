"""Shared set-up of the benchmark's own tests.

Tests that need a CUDA card carry the ``card`` marker and take the
``cuda_card`` fixture, which skips them where there is none; the decision
is made inside the fixture, never while a module is imported.  On the card:

    python3 -m pytest vqabench/tests -q -m card
"""

import time

import pytest
import torch

from vqabench import harness, spec

# every cell of BENCHMARK.json, for the tests that cover each cell
CELLS = list(spec.load().cells)


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
             seconds=0.2):
    """One run of ``workload`` through the harness at its rehearsal size
    (``rehearse.cpu`` of its workload and configuration files, or
    ``rehearse.card`` on a CUDA device), skipping the harness's look for a
    card."""
    overrides = spec.load().rehearsal(workload, "card" if device == "cuda" else "cpu")
    return harness.run(workload, seed, seconds, trace, t_start=time.perf_counter(),
                       device=device, overrides=overrides, mode=mode)
