"""The port's pipeline orchestrator (``novel_vqa_torch.pipeline.run_all``)
against the JAX package's, mirroring ``tests/test_run_all.py``: the example
config, the dry run and skip-on-existing-output, the unknown stage, a real
two-stage chain (corpus prepro -> text AE) whose outputs equal the JAX
chain's, and every ``STAGES`` entry naming an importable module of the port
with the named entry function.  The port's card stages default to
``cuda``, so its configs add ``--device cpu`` where a stage takes it; the
JAX chain gets the same config without it."""

import importlib
import io
import json
import os
from contextlib import redirect_stdout

import h5py
import numpy as np
import pytest

from novel_vqa_torch.core.checkpoint import load_npz
from novel_vqa_torch.core.h5 import H5Reader
from novel_vqa_torch.pipeline import run_all as trun
from novel_vqa_tpu.core.checkpoint import load_npz as jload_npz
from novel_vqa_tpu.pipeline import run_all as jrun


def test_print_example_config(capsys):
    trun.main(["--print_example_config"])
    cfg = json.loads(capsys.readouterr().out)
    jrun.main(["--print_example_config"])
    assert cfg == json.loads(capsys.readouterr().out)
    assert "train_vqa_arch1" in cfg


def test_dry_run_and_skip(tmp_path, capsys):
    existing = tmp_path / "done.h5"
    existing.write_text("x")
    cfg = {"prepro_book_corpus": {"args": ["--whatever"], "output": str(existing)},
           "convert_ae": {"args": [], "output": str(tmp_path / "missing.h5")}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    trun.main(["--config", str(cfg_path), "--dry_run"])
    out = capsys.readouterr().out
    assert "SKIP — output exists" in out
    assert "python -m novel_vqa_torch.train.convert_ae" in out
    assert not (tmp_path / "missing.h5").exists()


def test_unknown_stage_rejected(tmp_path):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"not_a_stage": {"args": []}}))
    with pytest.raises(ValueError, match="unknown stages"):
        trun.main(["--config", str(cfg_path), "--dry_run"])


def _chain_config(corpus, device=()):
    return {
        "prepro_book_corpus": {
            "args": ["--corpus", str(corpus), "--output_h5", "data.h5", "--output_json", "data.json",
                     "--num_val", "4", "--num_test", "4", "--word_count_threshold", "0",
                     "--max_length", "4"],
            "output": "data.h5",
        },
        "train_text_ae": {
            "args": ["--input_h5", "data.h5", "--input_json", "data.json", "--rnn_size", "8",
                     "--input_encoding_size", "6", "--batch_size", "8", "--max_iters", "4",
                     "--save_checkpoint_every", "3", "--val_sentences_use", "4",
                     "--losses_log_every", "2", "--checkpoint_path", "."] + list(device),
            "output": "model_id.npz",
        },
    }


def test_real_two_stage_chain(tmp_path, monkeypatch):
    """corpus prepro -> AE training through both orchestrators: the corpus
    files equal (json byte for byte, h5 datasets), the AE checkpoints with
    the same keys and shapes (their training draws differ), and a second
    run of the port's skips both stages."""
    corpus = tmp_path / "c.txt"
    corpus.write_text("\n".join(["the cat sat", "a dog ran", "birds fly high"] * 10) + "\n")
    for name, run, device in (("jax", jrun, ()), ("port", trun, ("--device", "cpu"))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        (d / "cfg.json").write_text(json.dumps(_chain_config(corpus, device)))
        run.main(["--config", "cfg.json"])
        assert os.path.exists("model_id.npz")
    j, t = tmp_path / "jax", tmp_path / "port"
    assert (t / "data.json").read_bytes() == (j / "data.json").read_bytes()
    with h5py.File(j / "data.h5", "r") as jf, H5Reader(str(t / "data.h5")) as tf:
        assert sorted(tf.datasets()) == ["label_length/test", "label_length/train", "label_length/val",
                                         "labels/test", "labels/train", "labels/val"]
        for k in tf.datasets():
            np.testing.assert_array_equal(tf[k], jf[k][()])
    jflat, _ = jload_npz(str(j / "model_id.npz"))
    tflat, _ = load_npz(str(t / "model_id.npz"))
    assert sorted(tflat) == sorted(jflat)
    assert all(np.shape(tflat[k]) == np.shape(jflat[k]) for k in jflat)
    buf = io.StringIO()
    with redirect_stdout(buf):
        trun.main(["--config", "cfg.json"])
    assert buf.getvalue().count("SKIP") == 2


def test_stages_name_the_ports_modules():
    """Each stage's module is the port's, imports, and has the entry
    function named; the stage names are the JAX orchestrator's, in its
    order.  (The isolation test's import check cannot see a module named
    in a string.)"""
    assert [s[0] for s in trun.STAGES] == [s[0] for s in jrun.STAGES]
    for (name, module, entry), (_, jmodule, jentry) in zip(trun.STAGES, jrun.STAGES):
        assert module.startswith("novel_vqa_torch.") and "novel_vqa_tpu" not in module, name
        assert module == jmodule.replace("novel_vqa_tpu.", "novel_vqa_torch.", 1) and entry == jentry
        assert callable(getattr(importlib.import_module(module), entry)), name
