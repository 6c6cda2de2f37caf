"""The port's AE training pieces against the JAX package's: the
optimizers, the corpus h5 (groups) and loader, the device-resident window
loop, the ``train_text_ae`` and ``convert_ae`` CLIs, and the language
metrics.

Tolerances: optimizer updates 1e-6; files, keys, windows and metrics exact.
"""

import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novel_vqa_tpu.core import checkpoint as jckpt
from novel_vqa_tpu.data.corpus import CorpusLoader as JCorpusLoader
from novel_vqa_tpu.eval import language_metrics as jlm
from novel_vqa_tpu.models.seq import autoencoder as jae
from novel_vqa_tpu.ops import optim as joptim
from novel_vqa_tpu.train import convert_ae as jconvert
from novel_vqa_tpu.train import train_text_ae as jtrain

from novel_vqa_torch.core import checkpoint as tckpt
from novel_vqa_torch.core.h5 import H5Reader, update_h5, write_h5
from novel_vqa_torch.core.tree import tree_map
from novel_vqa_torch.data.corpus import CorpusLoader
from novel_vqa_torch.eval import language_metrics as tlm
from novel_vqa_torch.ops import optim as toptim
from novel_vqa_torch.train import convert_ae as tconvert
from novel_vqa_torch.train import train_text_ae as ttrain

V, L = 15, 5
N_TRAIN, N_VAL = 60, 10
AE_ARGS = ["--rnn_size", "10", "--input_encoding_size", "8", "--batch_size", "16",
           "--learning_rate", "1e-3", "--val_sentences_use", "10", "--losses_log_every", "5"]


def _labels(rs, n):
    labels = np.zeros((n, L), np.uint32)
    for i, ln in enumerate(rs.randint(1, L + 1, size=n)):
        labels[i, :ln] = rs.randint(1, V + 1, size=ln)
    return labels


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A corpus h5 in the prepro schema (labels/* and label_length/*
    groups), written by h5py."""
    tmp = tmp_path_factory.mktemp("torch_corpus")
    rs = np.random.RandomState(0)
    splits = {"train": _labels(rs, N_TRAIN), "val": _labels(rs, N_VAL), "test": _labels(rs, N_VAL)}
    h5_path = str(tmp / "data.h5")
    with h5py.File(h5_path, "w") as f:
        for name, lab in splits.items():
            f.create_dataset(f"labels/{name}", dtype="uint32", data=lab)
            f.create_dataset(f"label_length/{name}", dtype="uint32", data=(lab != 0).sum(1))
    meta = str(tmp / "data.json")
    with open(meta, "w") as f:
        json.dump({"ix_to_word": {str(i): f"w{i}" for i in range(1, V + 1)},
                   "num_train": N_TRAIN, "num_val": N_VAL, "num_test": N_VAL}, f)
    return {"tmp": tmp, "h5": h5_path, "json": meta, "splits": splits}


# -- optimizers ---------------------------------------------------------------

def _opt_pairs():
    sched = lambda m: m.half_life_schedule(0.05, 1, 2)
    return {
        "sgd": lambda m: m.sgd(sched(m)),
        "sgdm": lambda m: m.sgdm(sched(m), 0.9),
        "sgdmom": lambda m: m.sgdmom(sched(m), 0.9),
        "adagrad": lambda m: m.adagrad(sched(m), 1e-8),
        "adam": lambda m: m.adam(sched(m), 0.8, 0.999, 1e-8),
        # the port chains the decay before rmsprop, as arch2's optimizer does
        "rmsprop_wd": lambda m: (
            m.rmsprop(0.01, 0.99, 1e-8, weight_decay=1e-2) if m is joptim
            else m.chain(m.add_decayed_weights(1e-2), m.rmsprop(0.01, 0.99, 1e-8))),
        "add_decayed_weights": lambda m: m.add_decayed_weights(0.1),
    }


def _three_steps(jtx, ttx):
    rs = np.random.RandomState(1)
    params = {"w": rs.randn(4, 3).astype(np.float32), "b": [rs.randn(3).astype(np.float32)]}
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), tree_map(torch.from_numpy, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(3):
        g = {"w": rs.randn(4, 3).astype(np.float32), "b": [rs.randn(3).astype(np.float32)]}
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update(tree_map(torch.from_numpy, g), ts, tp)
        for a, b in zip(jax.tree_util.tree_leaves(ju), [tu["b"][0], tu["w"]]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = toptim.apply_updates(tp, tu)


@pytest.mark.parametrize("name", sorted(_opt_pairs()))
def test_optimizer_updates_match_jax(name):
    build = _opt_pairs()[name]
    _three_steps(build(joptim), build(toptim))


@pytest.mark.parametrize("optim", ["adam", "rmsprop", "adagrad", "sgd", "sgdm", "sgdmom"])
def test_trainer_optimizer_chain_matches_jax(optim):
    """clamp -> decayed weights -> the chosen optimizer, as each trainer
    builds it (``make_tx``), on a half-life schedule that starts decaying."""
    flags = dict(optim=optim, learning_rate=0.05, grad_clip=0.5, weight_decay=1e-2,
                 learning_rate_decay_start=1, learning_rate_decay_every=2)
    _three_steps(jtrain.make_tx(jtrain.AETrainConfig(**flags)),
                 ttrain.make_tx(ttrain.AETrainConfig(**flags)))


def test_half_life_schedule_matches_jax():
    for start, every in ((-1, 5), (0, 3), (4, 7)):
        js, ts = joptim.half_life_schedule(2e-3, start, every), toptim.half_life_schedule(2e-3, start, every)
        for c in range(12):
            np.testing.assert_allclose(
                float(ts(torch.tensor(c, dtype=torch.int32))), float(js(jnp.asarray(c, jnp.int32))),
                rtol=1e-6)


# -- the corpus h5 and its loader ---------------------------------------------

def test_h5py_reads_groups_the_port_wrote(tmp_path):
    rs = np.random.RandomState(2)
    arrays = {"labels/train": _labels(rs, 7), "labels/val": _labels(rs, 3),
              "label_length/train": np.arange(7, dtype=np.uint32), "a/b/c": rs.randn(2, 2),
              "top": np.float32([1.5, 2.5])}
    path = str(tmp_path / "g.h5")
    write_h5(path, arrays)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["a", "label_length", "labels", "top"]
        assert sorted(f["labels"].keys()) == ["train", "val"]
        for k, v in arrays.items():
            np.testing.assert_array_equal(f[k][()], v)
            assert f[k].dtype == v.dtype
    with pytest.raises(ValueError, match="group"):
        write_h5(path, {"x": np.zeros(2), "x/y": np.zeros(2)})


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_port_reads_groups_and_row_windows_h5py_wrote(corpus, tmp_path, libver):
    path = str(tmp_path / f"{libver}.h5")
    with h5py.File(path, "w", libver=libver) as f:
        for name, lab in corpus["splits"].items():
            f.create_dataset(f"labels/{name}", data=lab)
        f.create_dataset("deep/er/x", data=np.arange(5.0))
    with H5Reader(path) as r:
        assert sorted(r.keys()) == ["deep", "labels"]
        assert sorted(r.datasets()) == ["deep/er/x", "labels/test", "labels/train", "labels/val"]
        assert "labels/train" in r and "labels/nope" not in r
        train = corpus["splits"]["train"]
        ds = r.dataset("labels/train")
        assert ds.shape == train.shape
        for a, b in ((0, 16), (50, 60), (55, 70), (59, 59)):
            np.testing.assert_array_equal(ds[a:b], train[a:b])
        np.testing.assert_array_equal(r["labels/val"], corpus["splits"]["val"])
        np.testing.assert_array_equal(r["deep/er/x"], np.arange(5.0))


def test_update_keeps_the_other_datasets(tmp_path):
    path = str(tmp_path / "s.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("KeepTest", data=np.arange(4, dtype=np.float32))
        f.create_dataset("g/inner", data=np.arange(3, dtype=np.int64))
        f.create_dataset("OutTest", data=np.zeros(2, np.float32))
    update_h5(path, {"OutTest": np.ones((2, 3), np.float32), "NewTest": np.full(2, 7, np.int32)})
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["KeepTest", "NewTest", "OutTest", "g"]
        np.testing.assert_array_equal(f["KeepTest"][()], np.arange(4, dtype=np.float32))
        np.testing.assert_array_equal(f["g/inner"][()], np.arange(3))
        np.testing.assert_array_equal(f["OutTest"][()], np.ones((2, 3), np.float32))
    fresh = str(tmp_path / "fresh.h5")
    update_h5(fresh, {"OutTest": np.ones(2, np.float32)})
    with h5py.File(fresh, "r") as f:
        assert list(f.keys()) == ["OutTest"]
    with open(str(tmp_path / "bad.h5"), "wb") as f:
        f.write(b"x" * 64)
    with pytest.raises(ValueError):
        update_h5(str(tmp_path / "bad.h5"), {"OutTest": np.ones(2, np.float32)})


def test_corpus_loader_matches_jax_across_wraps(corpus):
    jl, tl = JCorpusLoader(corpus["h5"], corpus["json"]), CorpusLoader(corpus["h5"], corpus["json"])
    assert (tl.vocab_size, tl.seq_length) == (jl.vocab_size, jl.seq_length)
    for split, bs, steps in (("train", 16, 9), ("val", 4, 7), ("train", 59, 4)):
        jl.reset_iterator(split)
        tl.reset_iterator(split)
        for _ in range(steps):
            (jb, jbound), (tb, tbound) = jl.get_batch(split, bs), tl.get_batch(split, bs)
            np.testing.assert_array_equal(tb, jb)
            assert tb.dtype == np.int32 and tbound == jbound
    np.testing.assert_array_equal(tl.split_rows("train"), corpus["splits"]["train"].astype(np.int32))
    jl.close()
    tl.close()


def test_device_windows_match_the_loader(corpus):
    """The windows of the multi-step loop (``scan_windows``) are the
    loader's, wrap included, as tests/test_ae_scan.py holds the JAX scan's."""
    rows = torch.from_numpy(corpus["splits"]["train"].astype(np.int32))
    for bs in (16, 7, 59):
        loader = CorpusLoader(corpus["h5"], corpus["json"])
        offset = torch.zeros((), dtype=torch.int64)
        for step in range(12):
            idx, offset = ttrain.scan_windows(offset, N_TRAIN, bs)
            batch, _ = loader.get_batch("train", bs)
            np.testing.assert_array_equal(rows[idx].t().numpy(), batch, err_msg=f"bs {bs} step {step}")
        loader.close()


# -- the CLIs -----------------------------------------------------------------

def _ae_argv(corpus, ckpt, *extra):
    return ["--input_h5", corpus["h5"], "--input_json", corpus["json"], "--checkpoint_path", ckpt,
            *AE_ARGS, *extra]


@pytest.mark.parametrize("variant,spd", [("text_nostart", 1), ("text_nostart", 5), ("arch2", 5)])
def test_train_text_ae_cli(corpus, tmp_path, capsys, variant, spd):
    ckpt = str(tmp_path / "ae")
    ttrain.main(_ae_argv(corpus, ckpt, "--variant", variant, "--max_iters", "10",
                         "--save_checkpoint_every", "5", "--steps_per_dispatch", str(spd),
                         "--sample_print", "2", "--language_eval", "1", "--device", "cpu"))
    out = capsys.readouterr().out
    losses = [float(ln.split()[-1]) for ln in out.splitlines() if ln.startswith("iter ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "Prediction: " in out and "language eval:" in out
    with open(os.path.join(ckpt, "model_id.json")) as f:
        log = json.load(f)
    assert log["iter"] == 9 and all(np.isfinite(list(log["val_loss_history"].values())))

    # the keys of the JAX trainer's checkpoint, and the JAX package loads it
    flat, meta = tckpt.load_npz(os.path.join(ckpt, "model_id.npz"))
    cfg = jae.AEConfig(**meta["cfg"])
    template = jax.device_get(jae.init_params(jax.random.PRNGKey(0), cfg))
    assert sorted(flat) == sorted(jckpt._flatten_tree(template))
    loaded = jckpt.unflatten_like(template, jckpt.load_npz(os.path.join(ckpt, "model_id.npz"))[0])
    for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(template)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_train_text_ae_cli_npz_keys_equal_the_jax_trainers(corpus, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    common = ["--max_iters", "2", "--save_checkpoint_every", "5"]
    jtrain.main(_ae_argv(corpus, jdir, *common))
    ttrain.main(_ae_argv(corpus, tdir, *common, "--device", "cpu"))
    jflat, jmeta = jckpt.load_npz(os.path.join(jdir, "model_id.npz"))
    tflat, tmeta = tckpt.load_npz(os.path.join(tdir, "model_id.npz"))
    assert sorted(tflat) == sorted(jflat)
    assert all(tflat[k].shape == jflat[k].shape and tflat[k].dtype == jflat[k].dtype for k in jflat)
    assert tmeta["cfg"] == jmeta["cfg"] and sorted(tmeta) == sorted(jmeta)
    with open(os.path.join(tdir, "model_id.json")) as f1, open(os.path.join(jdir, "model_id.json")) as f2:
        assert sorted(json.load(f1)) == sorted(json.load(f2))


def test_train_text_ae_start_from_resumes(corpus, tmp_path, capsys):
    """``--start_from`` loads a checkpoint: at learning rate 0 the first
    iteration's loss is the one the saved params give."""
    first = str(tmp_path / "a")
    ttrain.main(_ae_argv(corpus, first, "--max_iters", "6", "--save_checkpoint_every", "100",
                         "--device", "cpu"))
    capsys.readouterr()
    resumed = str(tmp_path / "b")
    argv = _ae_argv(corpus, resumed, "--max_iters", "1", "--learning_rate", "0", "--weight_decay", "0",
                    "--drop_prob_ae", "0", "--device", "cpu")
    ttrain.main(argv + ["--start_from", os.path.join(first, "model_id.npz")])
    flat_a, _ = tckpt.load_npz(os.path.join(first, "model_id.npz"))
    flat_b, _ = tckpt.load_npz(os.path.join(resumed, "model_id.npz"))
    for k in flat_a:
        np.testing.assert_array_equal(flat_b[k], flat_a[k])
    ttrain.main(argv)  # from a fresh init instead: other params
    flat_c, _ = tckpt.load_npz(os.path.join(resumed, "model_id.npz"))
    assert not np.array_equal(flat_c["lookup"], flat_a["lookup"])


def test_train_text_ae_refuses_unported_options(corpus, tmp_path):
    base = _ae_argv(corpus, str(tmp_path), "--max_iters", "1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.main(base)  # the default device is cuda
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.main(base + ["--data_parallel", "1"])  # DP never falls back to the CPU
    # ported: bf16 mixed precision trains (tests/test_torch_bf16.py)
    ttrain.main(base + ["--device", "cpu", "--compute_dtype", "bfloat16"])
    flat, meta = tckpt.load_npz(os.path.join(str(tmp_path), "model_id.npz"))
    assert meta["cfg"]["compute_dtype"] == "bfloat16"
    assert all(v.dtype == np.float32 and np.isfinite(v).all() for v in flat.values())
    with pytest.raises(ValueError, match="compute_dtype"):
        ttrain.main(base + ["--device", "cpu", "--compute_dtype", "float16"])


@pytest.mark.parametrize("variant,layers,multimodal", [
    ("text_nostart", 1, 0), ("text_nostart", 2, 0), ("vqa_arch", 1, 1)])
def test_convert_ae_matches_jax(tmp_path, variant, layers, multimodal):
    cfg = jae.AEConfig(vocab_size=V, input_encoding_size=8, rnn_size=10, num_layers=layers,
                       seq_length=L, variant=variant, nhimage=6)
    params = jax.device_get(jae.init_params(jax.random.PRNGKey(layers), cfg))
    tree = {"ae": params, "cnn": {"w": np.ones(3, np.float32)}} if variant == "vqa_arch" else params
    npz = str(tmp_path / "model_id.npz")
    jckpt.save_npz(npz, tree, meta={"cfg": cfg._asdict()})
    flags = ["--ae_model", npz, "--include_multimodal", str(multimodal)]
    jconvert.main(flags + ["--out", str(tmp_path / "j.h5")])
    tconvert.main(flags + ["--out", str(tmp_path / "t.h5"), "--device", "cpu"])
    with h5py.File(str(tmp_path / "j.h5"), "r") as fj, h5py.File(str(tmp_path / "t.h5"), "r") as ft:
        assert sorted(ft.keys()) == sorted(fj.keys())
        for k in fj.keys():
            np.testing.assert_array_equal(ft[k][()], fj[k][()])
            assert ft[k].dtype == fj[k].dtype
    back = tckpt.ae_transfer_from_h5(str(tmp_path / "t.h5"), 8, 10, layers)
    np.testing.assert_array_equal(back["lookup"], params["lookup"])
    for got, ref in zip(back["encoder"], params["encoder"]):
        for p in ("wx", "bx", "wh", "bh"):
            np.testing.assert_array_equal(got[p], ref[p])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tconvert.main(flags + ["--out", str(tmp_path / "x.h5")])


def test_language_eval_equals_jax():
    rs = np.random.RandomState(3)
    words = [f"w{i}" for i in range(8)]
    preds = []
    for _ in range(40):
        ref = " ".join(rs.choice(words, size=rs.randint(1, 9)))
        pred = ref if rs.rand() < 0.3 else " ".join(rs.choice(words, size=rs.randint(0, 9)))
        preds.append({"prediction": pred, "actual": ref})
    assert tlm.language_eval(preds) == jlm.language_eval(preds)
    cands, refs = [p["prediction"].split() for p in preds], [p["actual"].split() for p in preds]
    assert tlm.corpus_bleu(cands, refs, 3) == jlm.corpus_bleu(cands, refs, 3)
    assert tlm.cider_d(cands, refs, sigma=3.0) == jlm.cider_d(cands, refs, sigma=3.0)
