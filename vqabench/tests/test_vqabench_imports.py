"""What the benchmark loads: no JAX and no JAX package in a run, by whole
top-level module name, and references that take nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from vqabench.spec import PACKAGE

FORBIDDEN = {"jax", "jaxlib", "flax", "novel_vqa_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in PACKAGE.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("kind", ["refs", "flops"])
def test_references_and_counts_take_nothing_of_the_port(kind):
    allowed = {"__future__", "math", "typing", "torch"}
    for path in (PACKAGE / kind).glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in allowed or name.startswith(f"vqabench.{kind}"), (path, name)


def test_a_rehearsed_run_of_every_cell_loads_no_jax():
    script = (
        "import json, sys\n"
        "from vqabench.tests.conftest import CELLS, rehearse\n"
        "from vqabench import harness\n"
        "ok = {w: rehearse(w)[0]['correct'] for w in CELLS}\n"
        "print(json.dumps({'ok': ok, 'loaded': harness.forbidden_modules(),\n"
        "                  'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=PACKAGE.parent, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["ok"] and all(got["ok"].values()), got["ok"]
    assert got["loaded"] == []
    assert not set(got["tops"]) & FORBIDDEN
    assert "novel_vqa_torch" in got["tops"]
