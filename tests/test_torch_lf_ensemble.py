"""The port's late-fusion ensemble (``novel_vqa_torch.train.lf_ensemble``)
against the JAX tool on the CPU: ``compute``'s score matrices within 1e-4
(the arch1 eval's tolerance) in both store modes and for two member nets
with their own stores, the replacement of a dataset of the same name in a
file h5py wrote and changed, ``eval``'s OE and MC JSONs byte-identical to
the JAX tool's when both read the same scores file (written by either
package), and the refusals."""

import json
import shutil

import h5py
import jax
import numpy as np
import pytest
import torch

from novel_vqa_tpu.core.checkpoint import arch1_to_flat, save_flat_h5
from novel_vqa_tpu.models.vqa import arch1 as jarch1
from novel_vqa_tpu.train import lf_ensemble as jlf
from novel_vqa_torch.core.h5 import H5Reader
from novel_vqa_torch.train import lf_ensemble as tlf

V, T, N_ANS = 30, 6, 7
SIZES = {"train": 70, "val": 20, "test": 37}  # batch 16: every split ends short
NETS = {"VGG": 8, "Inception": 6}  # prefix -> feature width
WIDTHS = dict(input_encoding_size=12, rnn_size=16, rnn_layer=2, common_embedding_size=16,
              num_output=N_ANS)
KEYS = [f"{p}Out{s.capitalize()}" for p in NETS for s in SIZES]


@pytest.fixture(scope="module")
def lf(tmp_path_factory):
    """Synthetic splits (h5py), one image store and one JAX-initialised
    checkpoint per member net, and the JAX tool's scores file: VGG, then
    Inception, then VGG again (h5py deletes and re-creates its datasets,
    leaving freed space behind)."""
    tmp = tmp_path_factory.mktemp("lf")
    rs = np.random.RandomState(0)
    n_img = 15
    with h5py.File(tmp / "ques.h5", "w") as f:
        for split, n in SIZES.items():
            lengths = rs.randint(1, T + 1, size=n).astype(np.uint32)
            ques = np.zeros((n, T), np.uint32)
            for i, ln in enumerate(lengths):
                ques[i, :ln] = rs.randint(1, V + 1, size=ln)
            f.create_dataset(f"ques_{split}", data=ques)
            f.create_dataset(f"ques_length_{split}", data=lengths)
            f.create_dataset(f"question_id_{split}", data=np.arange(n, dtype=np.uint32) * 3 + 11)
            f.create_dataset(f"img_pos_{split}", data=rs.randint(1, n_img + 1, size=n).astype(np.uint32))
        f.create_dataset("answers", data=rs.randint(1, N_ANS + 1, size=SIZES["train"]).astype(np.uint32))
        f.create_dataset("answers_val", data=rs.randint(1, N_ANS + 1, size=SIZES["val"]).astype(np.uint32))
        mc = np.stack([rs.choice(N_ANS, 4, replace=False) + 1 for _ in range(SIZES["test"])]).astype(np.uint32)
        mc = np.concatenate([mc, np.zeros((SIZES["test"], 14), np.uint32)], axis=1)
        mc[::5, 2:] = 0  # fewer choices
        mc[3] = 0  # none: the OE answer
        f.create_dataset("MC_ans_test", data=mc)
    meta = {"ix_to_word": {str(i): f"w{i}" for i in range(1, V + 1)},
            "ix_to_ans": {str(i): f"a{i}" for i in range(1, N_ANS + 1)}}
    (tmp / "meta.json").write_text(json.dumps(meta))
    out = {"tmp": tmp, "ques": str(tmp / "ques.h5"), "meta": str(tmp / "meta.json")}
    for k, (prefix, width) in enumerate(NETS.items()):
        with h5py.File(tmp / f"img_{prefix}.h5", "w") as f:
            for split in SIZES:
                f.create_dataset(f"images_{split}", data=rs.rand(n_img, width).astype(np.float32))
        cfg = jarch1.Arch1Config(vocab_size=V, nhimage=width, **WIDTHS)
        for seed in (k, k + 10):  # the net's model and a second one
            save_flat_h5(str(tmp / f"m_{prefix}_{seed}.h5"),
                         arch1_to_flat(jax.device_get(jarch1.init_params(jax.random.PRNGKey(seed), cfg))))
    out["jax"] = str(tmp / "jax.h5")
    for prefix in ("VGG", "Inception", "VGG"):
        jlf.cli(_compute_argv(out, prefix, out["jax"]))
    return out


def _compute_argv(d, prefix, out_h5, seed=None, splits="train,val,test"):
    k = list(NETS).index(prefix)
    argv = ["compute", "--input_img_h5", str(d["tmp"] / f"img_{prefix}.h5"), "--input_ques_h5", d["ques"],
            "--input_json", d["meta"], "--model_path", str(d["tmp"] / f"m_{prefix}_{k if seed is None else seed}.h5"),
            "--out_h5", out_h5, "--prefix", prefix, "--splits", splits, "--batch_size", "16",
            "--nhimage", str(NETS[prefix])]
    for key, v in WIDTHS.items():
        argv += [f"--{key}", str(v)]
    return argv


def _read(path):
    with H5Reader(path) as f:
        return {name: f[name] for name in f.datasets()}


@pytest.mark.parametrize("hbm_resident", [1, 0])
def test_compute_matches_jax(lf, tmp_path, hbm_resident):
    path = str(tmp_path / "port.h5")
    for prefix in NETS:
        tlf.cli(_compute_argv(lf, prefix, path) + ["--hbm_resident", str(hbm_resident), "--device", "cpu"])
    got, ref = _read(path), _read(lf["jax"])  # the port reads the file h5py changed
    assert sorted(got) == sorted(ref) == sorted(KEYS)
    for key in KEYS:
        assert got[key].dtype == np.float32 and got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-4, err_msg=key)
    with h5py.File(path, "r") as f:  # and h5py reads the port's file
        for key in KEYS:
            np.testing.assert_array_equal(f[key][()], got[key])


def test_streaming_compute_reads_no_mc_rows_outside_the_test_split(lf, tmp_path):
    """With the test split loaded, the JAX package's streaming batches index
    the test split's MC rows with the train split's row numbers
    (``novel_vqa_tpu/data/vqa.py:204``) and fail past its end; the port's
    carry MC rows on the test split only (ROADMAP C), which the
    ``hbm_resident=0`` case above runs over all three splits."""
    with pytest.raises(IndexError):
        jlf.cli(_compute_argv(lf, "VGG", str(tmp_path / "j.h5")) + ["--hbm_resident", "0"])


def test_compute_replaces_a_dataset_of_the_same_name(lf, tmp_path):
    """A second compute under the VGG prefix (another model, the test split
    only) into the file the JAX tool wrote: VGGOutTest is the new model's,
    every other dataset is kept byte for byte."""
    path = str(tmp_path / "scores.h5")
    shutil.copy(lf["jax"], path)
    before = _read(path)
    tlf.cli(_compute_argv(lf, "VGG", path, seed=10, splits="test") + ["--device", "cpu"])
    fresh = str(tmp_path / "fresh.h5")
    tlf.cli(_compute_argv(lf, "VGG", fresh, seed=10, splits="test") + ["--device", "cpu"])
    after = _read(path)
    assert sorted(after) == sorted(KEYS)
    np.testing.assert_array_equal(after["VGGOutTest"], _read(fresh)["VGGOutTest"])
    assert np.abs(after["VGGOutTest"] - before["VGGOutTest"]).max() > 1e-3
    for key in KEYS:
        if key != "VGGOutTest":
            np.testing.assert_array_equal(after[key], before[key])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_eval_json_byte_identical_to_jax(lf, tmp_path, writer):
    scores = lf["jax"]
    if writer == "port":
        scores = str(tmp_path / "port.h5")
        for prefix in NETS:
            tlf.cli(_compute_argv(lf, prefix, scores, splits="test") + ["--device", "cpu"])
    argv = ["eval", "--scores_h5", scores, "--input_ques_h5", lf["ques"], "--input_json", lf["meta"],
            "--weight_vgg", "0.7", "--weight_inception", "0.3"]
    jlf.cli(argv + ["--out_path", str(tmp_path / "j") + "/"])
    tlf.cli(argv + ["--out_path", str(tmp_path / "t") + "/"])
    for name in ("OpenEnded_mscoco_lstm_results.json", "MultipleChoice_mscoco_lstm_results.json"):
        ref = (tmp_path / "j" / name).read_bytes()
        assert (tmp_path / "t" / name).read_bytes() == ref
        assert len(json.loads(ref)) == SIZES["test"]


def test_compute_refuses_data_parallel_and_a_missing_card(lf, tmp_path):
    missing = str(tmp_path / "nothere")
    argv = ["compute", "--input_img_h5", missing, "--input_ques_h5", missing, "--input_json", missing,
            "--model_path", missing]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tlf.cli(argv + ["--data_parallel", "1"])  # joins on the card, before any read
        with pytest.raises(RuntimeError, match="cuda"):
            tlf.cli(_compute_argv(lf, "VGG", str(tmp_path / "x.h5")))  # the default device is cuda
