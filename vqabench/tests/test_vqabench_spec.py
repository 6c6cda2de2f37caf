"""The harness is driven by data: on a copy of the benchmark, a new
configuration, cell and per-layer metrics are added by adding a config
JSON, a workload JSON (with its rehearsal sizes, faults and spans), a
fault module and metric files (and their entries in BENCHMARK.json), and
the harness lists, validates, rehearses and fault-tests the new cell, and
reads its span and counter metrics, with no other file touched.  Names
and units keep to their characters."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from vqabench import spec as S
from vqabench.spec import PACKAGE

ROOT = PACKAGE.parent


def _copy(tmp_path):
    shutil.copytree(PACKAGE, tmp_path / "vqabench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def _load_copy(root):
    name = f"vqabench_copy_spec_{abs(hash(str(root)))}"
    mod_spec = importlib.util.spec_from_file_location(name, root / "vqabench" / "spec.py")
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    try:
        mod_spec.loader.exec_module(mod)
        return mod.load(root)
    finally:
        del sys.modules[name]


FAULT_MODULE = """\
def _first_answer_off(original):
    def device_predict(scores, choices=None):
        pred, mc = original(scores, choices)
        pred = pred.clone()
        pred[0] = pred[0] % scores.shape[1] + 1
        return pred, mc
    return device_predict


FAULTS = {"first_answer": ("novel_vqa_torch.models.vqa.eval_paths", "device_predict",
                           _first_answer_off)}
"""
SPAN_READER = ("def read(m):\n"
               "    if m.spans is None or 'lstm.encode' not in m.spans:\n"
               "        return None\n"
               "    return 1e3 * m.spans['lstm.encode']['total_s'] / m.traced.steps\n")
COUNTER_READER = ("def read(m):\n"
                  "    if 'lstm_seq' not in m.counters:\n"
                  "        return None\n"
                  "    return m.counters['lstm_seq'] / m.steps\n")
NEW_METRICS = {"questions_per_pass.infer": ("questions", "program_counter", "eval loop",
                                            "def read(m):\n    return m.units / m.dispatches\n"),
               "encode_ms_per_batch.infer_l1": ("ms", "program_span", "model step", SPAN_READER),
               "seq_launches_per_batch.infer_l1": ("launches", "program_counter", "kernels",
                                                   COUNTER_READER)}


def _add_cell(root):
    cfg = json.loads((root / "vqabench/configs/arch1.json").read_text())
    cfg.update(name="arch1_l1", rnn_layer=1, reduced=["rnn_layer"], faults="arch1_l1")
    (root / "vqabench/configs/arch1_l1.json").write_text(json.dumps(cfg))
    (root / "vqabench/faults/arch1_l1.py").write_text(FAULT_MODULE)
    cell = json.loads((root / "vqabench/workloads/arch1.eval.json").read_text())
    cell.update(config="arch1_l1")
    cell["traffic"]["name"] = "vqa_v1_val_l1"
    cell["rehearse"] = {
        "cpu": {"cell": {"traffic": {"questions": 60, "images": 10, "answers": 10,
                                     "mc_choices": 4, "batch_size": 20}}},
        "card": {"cell": {"traffic": {"questions": 20000, "images": 4000}}},
        "faults": ["first_answer"], "spans": ["eval.upload", "lstm.encode"],
        "card_counts": {"seq_launches_per_batch.infer_l1": 1.0}}
    (root / "vqabench/workloads/arch1_l1.eval.json").write_text(json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "arch1_l1", "source": cfg["source"],
                             "file": "vqabench/configs/arch1_l1.json", "reduced": ["rnn_layer"],
                             "why": "one LSTM layer"})
    bench["workloads"].append({"name": "arch1_l1.eval", "config": "arch1_l1",
                               "traffic": "vqa_v1_val_l1", "chips": 1, "why": "a one-layer eval"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "arch1.eval" in m["workloads"]:
            m["workloads"].append("arch1_l1.eval")
    for name, (unit, source, layer, code) in NEW_METRICS.items():
        (root / f"vqabench/metrics/{name}.py").write_text(code)
        bench["per_layer"].append({"name": name, "unit": unit, "better": "higher",
                                   "source": source, "layer": layer,
                                   "moves": "infer_samples_per_s", "workloads": ["arch1_l1.eval"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_the_shipped_benchmark_validates():
    """Every cell that BENCHMARK.json lists keeps the rules: its workload
    file is there, it reports setup_s, another end-to-end metric and a
    per-layer metric, and it brings its rehearsal (sizes on the CPU and the
    card, faults, spans) for the tests that cover each cell."""
    raw = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = S.load()
    assert list(bench.cells) == [w["name"] for w in raw["workloads"]]
    for name, cell in bench.cells.items():
        e2e, layer = bench.metrics_of(name)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        assert (PACKAGE / "workloads" / f"{name}.json").is_file()
        rehearse = cell["rehearse"]
        assert rehearse["faults"] and rehearse["spans"], name
        for where in S.SIZES:
            assert bench.rehearsal(name, where)["cell"], (name, where)
        assert bench.configs[cell["config"]]["rehearse"]["cpu"], cell["config"]


def test_a_cell_config_and_metric_are_added_by_files_alone(tmp_path):
    root = _copy(tmp_path)
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    _add_cell(root)
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {type(next(iter(before)))("BENCHMARK.json")}
    bench = _load_copy(root)
    assert "arch1_l1.eval" in bench.cells and "arch1_l1" in bench.configs
    _, layer = bench.metrics_of("arch1_l1.eval")
    assert set(NEW_METRICS) <= {m["name"] for m in layer}

    # the copy as a checkout holds it: the benchmark's files and the port
    (root / "novel_vqa_torch").symlink_to(ROOT / "novel_vqa_torch", target_is_directory=True)
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="2")
    script = (
        "import json\n"
        "from vqabench import faults\n"
        "from vqabench.tests.conftest import rehearse\n"
        "r, _ = rehearse('arch1_l1.eval', trace=True)\n"
        "with faults.plant('arch1_l1.eval', 'first_answer'):\n"
        "    bad, _ = rehearse('arch1_l1.eval')\n"
        "print(json.dumps({'result': r, 'planted': bad['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    result = got["result"]
    assert result["correct"] and got["planted"] is False
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert metrics["questions_per_pass.infer"] == 60
    assert metrics["encode_ms_per_batch.infer_l1"] > 0
    assert metrics["seq_launches_per_batch.infer_l1"] == 0  # the CPU counts no launch

    # the copy's own tests that cover each cell take the new one up and pass
    tests = [f"vqabench/tests/test_vqabench_{t}.py" for t in
             ("faults", "phases", "readers", "card", "imports")]
    pytest_args = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", *tests]
    listed = subprocess.run([*pytest_args, "--collect-only"], cwd=root, env=env,
                            capture_output=True, text=True, timeout=300)
    assert listed.returncode == 0, listed.stdout[-2000:]
    new_ids = {line.split("::", 1)[1] for line in listed.stdout.splitlines()
               if "::" in line and "arch1_l1.eval" in line}
    assert new_ids == {
        "test_correct_comes_out_false_for_each_fault[arch1_l1.eval-sound]",
        "test_correct_comes_out_false_for_each_fault[arch1_l1.eval-first_answer]",
        "test_each_cell_reads_its_spans[arch1_l1.eval]",
        "test_every_span_and_counter_reader_reads[arch1_l1.eval]",
        "test_launches_on_the_card[arch1_l1.eval]",
        "test_control_fails_and_program_passes_on_the_card[program-arch1_l1.eval]",
        "test_control_fails_and_program_passes_on_the_card[control-arch1_l1.eval]",
    }
    ran = subprocess.run([*pytest_args, "-k", "arch1_l1 or rehearsed_run"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert ran.returncode == 0, ran.stdout[-3000:]
    assert "5 passed" in ran.stdout and "failed" not in ran.stdout, ran.stdout[-2000:]


@pytest.mark.parametrize("where,key,value", [
    ("end_to_end", "unit", "tokens per second"),
    ("end_to_end", "name", "ttft p95"),
    ("per_layer", "name", "a/b"),
    ("per_layer", "unit", "µs"),
    ("end_to_end", "bound", 0.3),
])
def test_bad_names_units_and_bounds_are_refused(tmp_path, where, key, value):
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench[where][0][key] = value
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError):  # the copy's SpecError
        _load_copy(root)


@pytest.mark.parametrize("key,value", [
    ("faults", ["no_such_fault"]),
    ("cpu", {"cell": [1, 2]}),
    ("card", "small"),
    ("spans", "train.forward"),
    ("card_counts", {"no_such_metric": 1.0}),
])
def test_bad_rehearsals_are_refused(tmp_path, key, value):
    root = _copy(tmp_path)
    path = root / "vqabench/workloads/arch1.train.json"
    cell = json.loads(path.read_text())
    cell["rehearse"][key] = value
    path.write_text(json.dumps(cell))
    with pytest.raises(ValueError):  # the copy's SpecError
        _load_copy(root)
