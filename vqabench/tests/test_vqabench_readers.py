"""The span and counter readers of every cell: rehearsed through the
harness with ``trace=True``, every ``program_span`` and
``program_counter`` metric that a cell lists reads a finite value.  On the
CPU the port's plain versions run and count no launch, so the launch
counters read 0; on the card (``-m card``) the counter metrics read what
the cell's ``rehearse.card_counts`` gives."""

import math

import pytest

from vqabench import spec
from vqabench import trace as T
from vqabench.tests.conftest import CELLS, rehearse

BENCH = spec.load()


def _program_metrics(cell):
    _, layer = BENCH.metrics_of(cell)
    return [m["name"] for m in layer if m["source"] in ("program_span", "program_counter")]


def _read(cell, result, lines):
    assert result["correct"], lines
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for name in _program_metrics(cell):
        assert name in got and math.isfinite(got[name]), (name, got)
    return got


@pytest.mark.parametrize("cell", CELLS)
def test_every_span_and_counter_reader_reads(cell, two_threads):
    result, lines = rehearse(cell, 20260420, trace=True)
    _read(cell, result, lines)
    assert result["launches"] and not any(result["launches"].values()), result["launches"]


def test_without_the_tracer_the_span_readers_read_nothing(monkeypatch, two_threads):
    monkeypatch.setattr(T, "tracer", lambda: None)
    result, lines = rehearse("text_ae.val", 20260420, trace=True)
    assert result["correct"], lines
    _, layer = BENCH.metrics_of("text_ae.val")
    spans = {m["name"] for m in layer if m["source"] == "program_span"}
    assert spans and not spans & set(result["metrics"])
    assert "kernel_launches_per_batch.infer" in result["metrics"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_launches_on_the_card(cell, cuda_card):
    result, lines = rehearse(cell, 20260421, trace=True, device="cuda", seconds=0.5)
    got = _read(cell, result, lines)
    for name, want in BENCH.cells[cell]["rehearse"].get("card_counts", {}).items():
        assert got[name] == want, (name, got[name], result["launches"])
