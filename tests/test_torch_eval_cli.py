"""End to end: the JAX and the port's arch1 eval CLIs read the same
synthetic split and the same flat ``lstm.h5`` and must write byte-identical
OpenEnded and MultipleChoice result JSONs, for both store modes."""

import json
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from novel_vqa_tpu.core.checkpoint import arch1_to_flat, save_flat_h5
from novel_vqa_tpu.data.vqa import VQAData as JVQAData
from novel_vqa_tpu.models.vqa import arch1 as jarch1
from novel_vqa_tpu.train import eval_vqa_arch1 as jeval

from novel_vqa_torch.core.convert import arch1_params_from_numpy
from novel_vqa_torch.data.vqa import VQAData as TVQAData
from novel_vqa_torch.models.vqa import arch1 as tarch1
from novel_vqa_torch.train import eval_vqa_arch1 as teval

V_Q = 40  # question vocab
N_ANS = 6
D = 8
WIDTHS = dict(
    nhimage=16, input_encoding_size=12, rnn_size=16, rnn_layer=2,
    common_embedding_size=16, num_output=N_ANS,
)
NAMES = (
    "OpenEnded_mscoco_val2014_lstm_novel_new_2_results.json",
    "MultipleChoice_mscoco_val2014_lstm_novel_new_2_results.json",
)


@pytest.fixture(scope="module")
def synthetic_dataset(tmp_path_factory):
    """The synthetic split of tests/test_e2e_m1.py (data files only): the
    answer is a function of the image feature cluster; questions are random
    tokens."""
    tmp = tmp_path_factory.mktemp("torch_eval")
    rs = np.random.RandomState(0)

    n_train, n_val, n_test, n_img = 400, 60, 60, 30
    img_ans = rs.randint(1, N_ANS + 1, size=n_img)  # answer per image
    feats = np.eye(N_ANS)[img_ans - 1] @ rs.randn(N_ANS, 16) + 0.05 * rs.randn(n_img, 16)
    feats = feats.astype(np.float32)

    def make_split(n):
        img_pos = rs.randint(1, n_img + 1, size=n).astype(np.uint32)
        lengths = rs.randint(1, D + 1, size=n).astype(np.uint32)
        ques = np.zeros((n, D), np.uint32)
        for i, L in enumerate(lengths):
            ques[i, :L] = rs.randint(1, V_Q + 1, size=L)
        qid = np.arange(1, n + 1, dtype=np.uint32)
        answers = img_ans[img_pos - 1].astype(np.uint32)
        return ques, lengths, qid, img_pos, answers

    tr = make_split(n_train)
    va = make_split(n_val)
    te = make_split(n_test)
    te_qid = te[2] + 10000

    mc = np.zeros((n_test, 18), np.uint32)
    for i in range(n_test):
        wrong = rs.choice(
            [a for a in range(1, N_ANS + 1) if a != te[4][i]], size=3, replace=False
        )
        choices = np.concatenate([[te[4][i]], wrong])
        rs.shuffle(choices)
        mc[i, : len(choices)] = choices

    ques_h5 = str(tmp / "data_prepro.h5")
    with h5py.File(ques_h5, "w") as f:
        f.create_dataset("ques_train", dtype="uint32", data=tr[0])
        f.create_dataset("ques_length_train", dtype="uint32", data=tr[1])
        f.create_dataset("answers", dtype="uint32", data=tr[4])
        f.create_dataset("question_id_train", dtype="uint32", data=tr[2])
        f.create_dataset("img_pos_train", dtype="uint32", data=tr[3])
        f.create_dataset("ques_val", dtype="uint32", data=va[0])
        f.create_dataset("ques_length_val", dtype="uint32", data=va[1])
        f.create_dataset("answers_val", dtype="uint32", data=va[4])
        f.create_dataset("question_id_val", dtype="uint32", data=va[2])
        f.create_dataset("img_pos_val", dtype="uint32", data=va[3])
        f.create_dataset("ques_test", dtype="uint32", data=te[0])
        f.create_dataset("ques_length_test", dtype="uint32", data=te[1])
        f.create_dataset("question_id_test", dtype="uint32", data=te_qid)
        f.create_dataset("img_pos_test", dtype="uint32", data=te[3])
        f.create_dataset("MC_ans_test", dtype="uint32", data=mc)

    img_h5 = str(tmp / "data_img.h5")
    with h5py.File(img_h5, "w") as f:
        f.create_dataset("images_train", dtype="float32", data=feats)
        f.create_dataset("images_val", dtype="float32", data=feats)
        f.create_dataset("images_test", dtype="float32", data=feats)

    meta = {
        "ix_to_word": {str(i): f"w{i}" for i in range(1, V_Q + 1)},
        "ix_to_ans": {str(i): f"ans{i}" for i in range(1, N_ANS + 1)},
        "unique_img_train": [f"im{i}.jpg" for i in range(n_img)],
        "unique_img_val": [f"im{i}.jpg" for i in range(n_img)],
        "unique_img_test": [f"im{i}.jpg" for i in range(n_img)],
    }
    meta_json = str(tmp / "data_prepro.json")
    with open(meta_json, "w") as f:
        json.dump(meta, f)

    # one flat checkpoint from the JAX package's init, written by its own
    # writer; the fusion and classifier weights are scaled so that the
    # answers vary across questions and score margins are wide
    cfg = jarch1.Arch1Config(vocab_size=V_Q, **WIDTHS)
    params = jax.device_get(jarch1.init_params(jax.random.PRNGKey(7), cfg))
    for block, key, scale in (("fusion", "wq", 10.0), ("fusion", "wi", 20.0), ("classifier", "w", 40.0)):
        params[block][key] = params[block][key] * scale
    model_h5 = str(tmp / "lstm.h5")
    save_flat_h5(model_h5, arch1_to_flat(params))

    return {
        "tmp": tmp, "ques_h5": ques_h5, "img_h5": img_h5, "meta_json": meta_json,
        "model_h5": model_h5, "params": params,
    }


def _argv(d, out_dir, hbm_resident):
    argv = [
        "--input_img_h5", d["img_h5"],
        "--input_ques_h5", d["ques_h5"],
        "--input_json", d["meta_json"],
        "--model_path", d["model_h5"],
        "--batch_size", "16",  # 60 questions: a short final batch
        "--out_path", out_dir,
        "--hbm_resident", str(hbm_resident),
    ]
    for k, v in WIDTHS.items():
        argv += [f"--{k}", str(v)]
    return argv


def _tdata(d):
    return TVQAData(d["ques_h5"], d["img_h5"], d["meta_json"], load_test=True)


def test_score_margins_leave_no_near_tie(synthetic_dataset):
    """Guard for the byte-identity test: two frameworks sum in different
    orders, so a top-2 margin under 1e-4 could flip an argmax."""
    d = synthetic_dataset
    data = _tdata(d)
    store = data.split_store("test")
    cfg = tarch1.Arch1Config(vocab_size=data.vocab_size, **WIDTHS)
    with torch.inference_mode():
        scores = tarch1.apply(
            arch1_params_from_numpy(d["params"], "cpu"), cfg,
            torch.from_numpy(store["tokens"]),
            torch.from_numpy(store["image"][store["img_pos"] - 1]),
        ).numpy()
    top2 = np.sort(scores, axis=1)[:, -2:]
    assert np.min(top2[:, 1] - top2[:, 0]) > 1e-4
    for row, choices in zip(scores, store["mc_ans"]):
        valid = np.sort(row[choices[choices != 0] - 1])
        assert valid.size < 2 or valid[-1] - valid[-2] > 1e-4


@pytest.mark.parametrize("hbm_resident", [1, 0])
def test_eval_cli_json_byte_identical_to_jax(synthetic_dataset, hbm_resident):
    d = synthetic_dataset
    j_out = str(d["tmp"] / f"jax_{hbm_resident}") + "/"
    t_out = str(d["tmp"] / f"torch_{hbm_resident}") + "/"
    jeval.main(_argv(d, j_out, hbm_resident))
    teval.main(_argv(d, t_out, hbm_resident) + ["--device", "cpu"])
    for name in NAMES:
        with open(j_out + name, "rb") as f1, open(t_out + name, "rb") as f2:
            ref = f1.read()
            assert f2.read() == ref
        assert len(json.loads(ref)) == 60


def test_vqa_data_matches_jax(synthetic_dataset):
    d = synthetic_dataset
    jd = JVQAData(d["ques_h5"], d["img_h5"], d["meta_json"], load_test=True)
    td = _tdata(d)
    js, ts = jd.split_store("test"), td.split_store("test")
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    # the port's iter_split does not pad (its eval loop pads with the last
    # row); JAX's row-0 pad is not ported, so the unpadded batches compare
    jbatches = list(jd.iter_split("test", 16, pad_to_batch=False))
    tbatches = list(td.iter_split("test", 16))
    assert len(tbatches) == len(jbatches) == 4 and len(tbatches[-1].question_id) == 12
    for jb, tb in zip(jbatches, tbatches):
        np.testing.assert_array_equal(tb.tokens, jb.tokens)
        np.testing.assert_array_equal(tb.image, jb.image)
        np.testing.assert_array_equal(tb.labels, jb.labels)
        np.testing.assert_array_equal(tb.question_id, jb.question_id)
        np.testing.assert_array_equal(tb.mc_answers, jb.mc_answers)


def test_eval_cli_refuses_missing_card_and_data_parallel(synthetic_dataset, tmp_path):
    d = synthetic_dataset
    argv = _argv(d, str(tmp_path) + "/", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            teval.main(argv)  # the default device is cuda
        with pytest.raises(RuntimeError, match="cuda"):
            teval.main(argv + ["--data_parallel", "1"])  # DP never falls back to the CPU
    # on the CPU, one process: the DP route writes the plain run's JSONs
    plain, dp = str(tmp_path / "plain") + "/", str(tmp_path / "dp") + "/"
    teval.main(_argv(d, plain, 1) + ["--device", "cpu"])
    teval.main(_argv(d, dp, 1) + ["--device", "cpu", "--data_parallel", "1"])
    for name in sorted(os.listdir(plain)):
        with open(plain + name) as f1, open(dp + name) as f2:
            assert f1.read() == f2.read(), name


def test_eval_cli_refuses_data_parallel_before_reading_data(tmp_path):
    """``--data_parallel 1`` joins the group at the top of ``main``: without
    a card the default device raises there, and files that do not exist
    are never opened."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device would run")
    missing = str(tmp_path / "nothere")
    argv = ["--input_img_h5", missing, "--input_ques_h5", missing, "--input_json", missing,
            "--model_path", missing, "--out_path", str(tmp_path / "out") + "/", "--data_parallel", "1"]
    with pytest.raises(RuntimeError, match="cuda"):
        teval.main(argv)
    assert not (tmp_path / "out").exists()
