"""The port's real-dimension rehearsal (``novel_vqa_torch/utils/
rehearsal.py``): its data generators against the JAX tool's
(``novel_vqa_tpu/utils/rehearsal.py``), and a run at --scale 0.01 on the CPU
at the FULL model width (12,782-word vocabulary, 4096-d fc7, 2x512 LSTM;
only the data volume is scaled) whose report has every stage key that
tests/test_rehearsal.py asserts."""

import json

import h5py
import numpy as np
import pytest
import torch

from novel_vqa_tpu.utils import rehearsal as jreh

from novel_vqa_torch.core.h5 import H5Reader
from novel_vqa_torch.utils import rehearsal as treh


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs: the suite runs
    several test processes on one host, and full-width CPU work with a
    thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


N_WORDS, N_ANSWERS = 12782, 1000  # the frozen vocabularies' sizes


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """A synthetic vocabulary of the real sizes (the repo has no vocabs/)."""
    d = tmp_path_factory.mktemp("vocabs")
    (d / "vocab_train.json").write_text(json.dumps([f"w{i}" for i in range(N_WORDS)]))
    (d / "oracle_extern_ans_vocab.json").write_text(
        json.dumps([f"answer {i}" for i in range(N_ANSWERS)]))
    return d


def test_generators_match_jax(tmp_path, vocab_dir):
    words = json.loads((vocab_dir / "vocab_train.json").read_text())
    answers = json.loads((vocab_dir / "oracle_extern_ans_vocab.json").read_text())
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    args = (300, 120, 80, 30, words, answers)
    jq, jrows = jreh.gen_raw(str(tmp_path / "j"), *args)
    tq, trows = treh.gen_raw(str(tmp_path / "t"), *args)
    assert tq == jq and trows == jrows
    for name in ("raw_train.json", "raw_test.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    meta = tmp_path / "meta.json"
    # more than one 8192-row chunk in train
    meta.write_text(json.dumps({"unique_img_train": list(range(8200)),
                                "unique_img_test": list(range(7))}))
    jsizes = jreh.gen_fc7(str(tmp_path / "j.h5"), str(meta), ndims=16)
    tsizes = treh.gen_fc7(str(tmp_path / "t.h5"), str(meta), ndims=16)
    assert tsizes == jsizes == {"train": 8200, "test": 7}
    with h5py.File(tmp_path / "j.h5", "r") as jf, H5Reader(str(tmp_path / "t.h5")) as tf:
        assert sorted(tf.keys()) == sorted(jf.keys())
        for k in jf.keys():
            np.testing.assert_array_equal(tf[k], jf[k][()])


def test_rehearsal_smoke(tmp_path, vocab_dir, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the tool changes into its work dir
    report_path = tmp_path / "report.json"
    treh.main([
        "--work_dir", str(tmp_path / "work"), "--scale", "0.01", "--iters", "10",
        "--steps_per_dispatch", "5", "--batch_size", "100", "--extract_images", "0",
        "--vocab_dir", str(vocab_dir), "--report", str(report_path), "--device", "cpu",
    ])
    report = json.loads(report_path.read_text())
    assert report["dims"]["train_questions"] == int(215_000 * 0.01)
    assert report["dims"]["test_questions"] == int(121_512 * 0.01)
    assert report["dims"]["fc7_store"]["train"] > 0
    for stage in ("gen_raw", "prepro_vqa", "gen_fc7_store",
                  "train_1k_iters", "eval_full_split", "vqa_eval", "total"):
        assert stage in report["wall_s"], stage
    assert report["train"]["iters"] == 10
    assert report["train"]["projection_150k_iters_hours_incl_setup"] > 0
    assert report["accuracy_sanity"]["overall"] is not None
    assert report["accuracy_sanity"]["novel"] is not None
    # a CPU run launches no kernel and has no device memory to report
    assert report["launches"]["eval"] == {"lstm_seq": 0, "lstm_step": 0, "lstm_seq2": 0}
    assert "unavailable" in report["memory"]["after_train"]
    res = tmp_path / "work" / "result"
    for kind in ("OpenEnded", "MultipleChoice"):
        assert (res / f"{kind}_mscoco_val2014_lstm_novel_new_2_results.json").exists()


def test_rehearsal_defaults_to_the_card(tmp_path, vocab_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        treh.main(["--work_dir", str(tmp_path), "--vocab_dir", str(vocab_dir)])
    assert not any(tmp_path.iterdir())  # nothing generated before the refusal
