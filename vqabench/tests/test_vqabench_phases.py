"""``phases.py``: the program's spans read in a cell, on the CPU at a small
size; the idle gaps' labels on a synthetic profile."""

import pytest

from vqabench import phases
from vqabench.tests.conftest import SMALL_CELL, SMALL_CONFIG

# the spans each cell's calls must hold, and those that cover its host time
SPANS = {
    "arch1.train": {"train.sample", "train.forward", "train.backward", "train.reduce",
                    "train.update", "lstm.encode"},
    "text_ae.train": {"train.sample", "train.forward", "train.backward", "train.reduce",
                      "train.update", "lstm.encode"},
    "arch1.eval": {"eval.upload", "lstm.encode"},
    "text_ae.val": {"ae.nll", "ae.greedy", "lstm.encode"},
}


def _cell(workload):
    name = workload.split(".")[0]
    return phases.make_cell(workload, 20260418, device="cpu",
                            overrides={"config": SMALL_CONFIG[name],
                                       "cell": SMALL_CELL[workload]})


@pytest.mark.parametrize("workload", sorted(SPANS))
def test_each_cell_reads_its_spans(workload, two_threads):
    cell = _cell(workload)
    out = phases.measure(cell, seconds=0.05, rounds=2)
    cell.free()
    spans = out["spans"]
    assert set(spans["by_name"]) == SPANS[workload]
    k, per = cell.traced_dispatches, cell.steps_per_dispatch
    for name, st in spans["by_name"].items():
        assert st["ms_per_step"] > 0 and st["self_ms_per_step"] <= st["ms_per_step"]
        if name.startswith("train."):
            assert st["count"] == k * per
    assert 0 < spans["covered_share"] <= 1
    assert len(out["on_cost"]["on_ms_per_step"]) == len(out["on_cost"]["off_ms_per_step"]) == 2
    assert out["window"]["host_ms_per_step"] > 0


def test_without_the_tracer_the_span_readings_are_none(monkeypatch, two_threads):
    monkeypatch.setattr(phases, "_tracer", lambda: None)
    cell = _cell("text_ae.val")
    out = phases.measure(cell, seconds=0.05, rounds=2)
    cell.free()
    assert out["spans"] is None and out["on_cost"] is None
    assert out["idle_gaps"]["program_share"] in (0.0, None)
    assert out["window"]["host_ms_per_step"] > 0


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_gap_labels_name_the_innermost_program_span():
    events = [
        _x("user_annotation", "vqabench.traced", 0, 100),
        _x("user_annotation", "vqabench.dispatch", 0, 90),
        _x("user_annotation", "nvqa.train.forward", 10, 30),
        _x("user_annotation", "nvqa.lstm.encode", 15, 10),
        _x("cpu_op", "aten::mm", 16, 2),
        _x("user_annotation", "nvqa.train.update", 60, 20),
        # the card: busy 0-10, 12-15, 20-60, 70-95; another thread's op is not the host's
        _x("kernel", "k0", 0, 10, tid=7), _x("kernel", "k1", 12, 3, tid=7),
        _x("kernel", "k2", 20, 40, tid=7), _x("kernel", "k3", 70, 25, tid=7),
        _x("cpu_op", "aten::other_thread", 9, 3, tid=2),
    ]
    got = phases.label_gaps(events)
    gaps = dict(got["gaps"])
    # 10-12 inside forward, 15-20 inside the encode (starting in python beside aten::mm)
    assert gaps == {
        "vqabench.dispatch/nvqa.train.forward/python": pytest.approx(2e-6),
        "vqabench.dispatch/nvqa.lstm.encode/python": pytest.approx(5e-6),
        "vqabench.dispatch/nvqa.train.update/python": pytest.approx(10e-6),
        "harness/python": pytest.approx(5e-6),  # 95-100: outside the dispatch
    }
    assert got["program_share"] == pytest.approx(17 / 22)
    assert got["listed_share"] == got["program_share"]
    assert phases.label_gaps(events[1:]) == {"gaps": [], "program_share": None,
                                             "listed_share": None}
