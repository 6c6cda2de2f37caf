"""The harness is driven by data: on a copy of the benchmark, a new
configuration, cell and per-layer metric are added by adding a config
JSON, a workload JSON and a metric file (and their entries in
BENCHMARK.json), and the harness lists, validates and runs the new cell
with no other file touched.  Names and units keep to their characters."""

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
    shutil.copytree(PACKAGE, tmp_path / "vqabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
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


def _add_cell(root):
    cfg = json.loads((root / "vqabench/configs/arch1.json").read_text())
    cfg.update(name="arch1_l1", rnn_layer=1, reduced=["rnn_layer"])
    (root / "vqabench/configs/arch1_l1.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "vqabench/workloads/arch1.eval.json").read_text())
    cell.update(config="arch1_l1")
    cell["traffic"]["name"] = "vqa_v1_val_l1"
    (root / "vqabench/workloads/arch1_l1.eval.json").write_text(json.dumps(cell))
    (root / "vqabench/metrics/questions_per_pass.infer.py").write_text(
        "def read(m):\n    return m.units / m.dispatches\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "arch1_l1", "source": cfg["source"],
                             "file": "vqabench/configs/arch1_l1.json", "reduced": ["rnn_layer"],
                             "why": "one LSTM layer"})
    bench["workloads"].append({"name": "arch1_l1.eval", "config": "arch1_l1",
                               "traffic": "vqa_v1_val_l1", "chips": 1, "why": "a one-layer eval"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "arch1.eval" in m["workloads"]:
            m["workloads"].append("arch1_l1.eval")
    bench["per_layer"].append({"name": "questions_per_pass.infer", "unit": "questions",
                               "better": "higher", "source": "program_counter", "layer": "eval loop",
                               "moves": "infer_samples_per_s", "workloads": ["arch1_l1.eval"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_the_shipped_benchmark_validates():
    bench = S.load()
    assert list(bench.cells) == ["arch1.train", "text_ae.train", "arch1.eval", "text_ae.val"]
    for name in bench.cells:
        e2e, layer = bench.metrics_of(name)
        assert "setup_s" in {m["name"] for m in e2e} and layer


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
    assert "questions_per_pass.infer" in {m["name"] for m in layer}
    script = (
        "import json, time\n"
        "from vqabench import harness\n"
        "r, _ = harness.run('arch1_l1.eval', 5, 0.1, True, t_start=time.perf_counter(), device='cpu',\n"
        "    overrides={'config': {'vocab_size': 50, 'input_encoding_size': 8, 'rnn_size': 16,\n"
        "    'nhimage': 32, 'common_embedding_size': 24, 'num_output': 10}, 'cell': {'traffic':\n"
        "    {'questions': 60, 'images': 10, 'answers': 10, 'mc_choices': 4, 'batch_size': 20}}})\n"
        "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}", OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["questions_per_pass.infer"]["value"] == 60


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
