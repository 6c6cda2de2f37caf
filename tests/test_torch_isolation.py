"""The port stands alone: no module of ``novel_vqa_torch`` and not
``chip_smoke.py`` imports JAX, the JAX package or the JAX bench
(``bench.py``), and the kernel modules import where there is neither nvcc
nor a card (the build happens at the first launch)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "novel_vqa_tpu", "bench")


def _sources():
    files = sorted((ROOT / "novel_vqa_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_port_imports_without_nvcc_jax_or_card(tmp_path):
    """In a fresh interpreter with no nvcc on PATH and no card: import the
    port's entry points (and with them every module they reach), run the seq wrapper on CPU tensors (its plain
    version) and the VGG prepro, and check that neither JAX nor the JAX
    package was loaded, that nothing was built (neither a kernel nor the
    native decoder) and that the pipeline's NLTK, scikit-learn and spaCy
    are not imported before a stage needs them."""
    code = (
        "import sys, torch\n"
        "import novel_vqa_torch.train.eval_vqa_arch1\n"
        "import novel_vqa_torch.train.extract_features, novel_vqa_torch.train.import_caffe\n"
        "import novel_vqa_torch.eval.drivers, novel_vqa_torch.eval.demo\n"
        "import novel_vqa_torch.train.train_text_ae, novel_vqa_torch.train.convert_ae\n"
        "import novel_vqa_torch.train.train_vqa_arch2, novel_vqa_torch.train.eval_vqa_arch2\n"
        "import novel_vqa_torch.train.train_weakpaired_ae, novel_vqa_torch.train.compute_mean_vectors\n"
        "import novel_vqa_torch.train.import_t7, novel_vqa_torch.train.import_pth\n"
        "import novel_vqa_torch.train.lf_ensemble, novel_vqa_torch.pipeline.run_all\n"
        "from novel_vqa_torch.pipeline import tokenize, pos, vqa_preprocessing, prepro_vqa\n"
        "from novel_vqa_torch.pipeline import prepro_book_corpus, novel_split, correction, quality_eval\n"
        "from novel_vqa_torch.data import images, native_images\n"
        "import novel_vqa_torch.core.device_bench, novel_vqa_torch.parallel.mesh, novel_vqa_torch.parallel.dp\n"
        "from novel_vqa_torch.utils import selfcheck, op_profile, validate_weights, rehearsal\n"
        "from novel_vqa_torch.kernels import build, lstm\n"
        "xs = torch.zeros(3, 2, 4); m = torch.ones(3, 2)\n"
        "lstm.lstm_seq(xs, m, torch.zeros(4, 8), torch.zeros(2, 8), torch.zeros(8))\n"
        "images.vgg_device_prepro(torch.zeros(1, 4, 4, 3, dtype=torch.uint8), torch.zeros(1, dtype=torch.bool))\n"
        "assert build.library.cache_info().currsize == 0\n"
        "assert not native_images._state  # the decoder is built at first use only\n"
        "assert lstm.lstm_seq.launches == 0\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "lazy = [m for m in ('nltk', 'sklearn', 'spacy') if m in sys.modules]\n"
        "assert not lazy, lazy  # the pipeline imports them at first use\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update(PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without a card (and, alone, without the port beside it) the smoke
    script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the smoke script would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
