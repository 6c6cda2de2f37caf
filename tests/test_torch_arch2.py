"""The port's arch2 against the JAX package's: the forward, one training
step, the flat ``lstm.h5`` both ways, and the CLIs on an h5py-written
split, whose eval JSONs must be byte-identical to the JAX CLI's.

The test split's row 0 is a full-length question and every question of
its final short batch is shorter, so a final batch padded with row 0
would run extra encoder steps: the port pads with the last row in both
store modes (the JAX package's streaming path pads with row 0 and differs).
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
from novel_vqa_tpu.models.seq import autoencoder as jae
from novel_vqa_tpu.models.vqa import arch2 as jarch2
from novel_vqa_tpu.train import eval_vqa_arch2 as jeval

from novel_vqa_torch.core import checkpoint as tckpt
from novel_vqa_torch.core.convert import arch2_params_from_numpy, arch2_params_to_numpy
from novel_vqa_torch.core.tree import tree_leaves
from novel_vqa_torch.data.vqa import VQAData
from novel_vqa_torch.models.vqa import arch2 as tarch2
from novel_vqa_torch.train import eval_vqa_arch2 as teval
from novel_vqa_torch.train import train_vqa_arch2 as ttrain
from novel_vqa_torch.train.eval_loop import run_full_split

V, D, N_ANS, F, E, H = 30, 6, 5, 8, 12, 16
N_TEST, BATCH = 40, 16  # the final batch: rows 32-39
WIDTHS = dict(nhimage=F, input_encoding_size=E, rnn_size=H, num_output=N_ANS)
TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = (
    "OpenEnded_mscoco_val2014_lstm_novel_new_2_results.json",
    "MultipleChoice_mscoco_val2014_lstm_novel_new_2_results.json",
)


def _cfg(cls, **kw):
    return cls(vocab_size=V, seq_length=D, **{**WIDTHS, **kw})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_arch2")
    rs = np.random.RandomState(0)
    n_img = 12
    img_ans = rs.randint(1, N_ANS + 1, size=n_img)
    feats = (np.eye(N_ANS)[img_ans - 1] @ rs.randn(N_ANS, F) + 0.1 * rs.randn(n_img, F)).astype(np.float32)

    def mk(n, qid0, lens=None):
        img_pos = rs.randint(1, n_img + 1, size=n).astype(np.uint32)
        lens = rs.randint(1, D + 1, size=n) if lens is None else lens
        q = np.zeros((n, D), np.uint32)
        for i, ln in enumerate(lens):
            q[i, :ln] = rs.randint(1, V + 1, size=ln)  # LEFT-aligned
        qid = np.arange(qid0 + 1, qid0 + n + 1, dtype=np.uint32)
        return q, np.asarray(lens, np.uint32), qid, img_pos, img_ans[img_pos - 1].astype(np.uint32)

    test_lens = rs.randint(1, D + 1, size=N_TEST)
    test_lens[0] = D  # row 0 the longest question ...
    test_lens[32:] = rs.randint(1, 3, size=N_TEST - 32)  # ... the final batch short
    tr, va, te = mk(200, 0), mk(40, 300), mk(N_TEST, 500, test_lens)
    mc = np.zeros((N_TEST, 18), np.uint32)
    mc[:, 0] = te[4]
    mc[:, 1] = (te[4] % N_ANS) + 1
    mc[:, 2] = ((te[4] + 1) % N_ANS) + 1
    ques_h5 = str(tmp / "data_prepro.h5")
    with h5py.File(ques_h5, "w") as f:
        for name, s in (("train", tr), ("val", va), ("test", te)):
            f.create_dataset(f"ques_{name}", dtype="uint32", data=s[0])
            f.create_dataset(f"ques_length_{name}", dtype="uint32", data=s[1])
            f.create_dataset(f"question_id_{name}", dtype="uint32", data=s[2])
            f.create_dataset(f"img_pos_{name}", dtype="uint32", data=s[3])
        f.create_dataset("answers", dtype="uint32", data=tr[4])
        f.create_dataset("answers_val", dtype="uint32", data=va[4])
        f.create_dataset("MC_ans_test", dtype="uint32", data=mc)
    img_h5 = str(tmp / "data_img.h5")
    with h5py.File(img_h5, "w") as f:
        for s in ("train", "val", "test"):
            f.create_dataset(f"images_{s}", dtype="float32", data=feats)
    meta = str(tmp / "data_prepro.json")
    with open(meta, "w") as f:
        json.dump({
            "ix_to_word": {str(i): f"w{i}" for i in range(1, V + 1)},
            "ix_to_ans": {str(i): f"a{i}" for i in range(1, N_ANS + 1)},
            "unique_img_train": [], "unique_img_val": [], "unique_img_test": [],
        }, f)

    # one flat checkpoint from the JAX package's init, written by its own
    # writer, the classifier scaled so that score margins are wide
    params = jax.device_get(jarch2.init_params(jax.random.PRNGKey(3), _cfg(jarch2.Arch2Config)))
    params["cnn_proj"]["w"] = params["cnn_proj"]["w"] * 20.0
    params["classifier"]["w"] = params["classifier"]["w"] * 200.0
    model_h5 = str(tmp / "lstm.h5")
    jckpt.save_flat_h5(model_h5, jckpt.arch2_to_flat(params))
    return {"tmp": tmp, "ques_h5": ques_h5, "img_h5": img_h5, "meta": meta,
            "model_h5": model_h5, "params": params, "test_lens": test_lens}


def _data_argv(d):
    return ["--input_img_h5", d["img_h5"], "--input_ques_h5", d["ques_h5"],
            "--input_json", d["meta"]] + [a for k, v in WIDTHS.items() for a in (f"--{k}", str(v))]


def _eval_argv(d, out_dir, model, hbm_resident=1):
    return _data_argv(d) + ["--model_path", model, "--batch_size", str(BATCH),
                            "--out_path", out_dir, "--hbm_resident", str(hbm_resident)]


def _inputs(seed, n=9):
    rs = np.random.RandomState(seed)
    tokens = np.zeros((n, D), np.int32)
    for i, ln in enumerate(rs.randint(1, D + 1, size=n)):
        tokens[i, :ln] = rs.randint(1, V + 1, size=ln)
    return tokens, rs.randn(n, F).astype(np.float32)


def test_apply_matches_jax():
    jcfg = _cfg(jarch2.Arch2Config, num_layers=2)
    params = jax.device_get(jarch2.init_params(jax.random.PRNGKey(1), jcfg))
    tokens, image = _inputs(1)
    ref = jarch2.apply(params, jcfg, jnp.asarray(tokens), jnp.asarray(image))
    got = tarch2.apply(arch2_params_from_numpy(params, "cpu"), _cfg(tarch2.Arch2Config, num_layers=2),
                       torch.from_numpy(tokens), torch.from_numpy(image))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_flat_roundtrip_both_ways(tmp_path):
    jcfg, tcfg = _cfg(jarch2.Arch2Config, num_layers=2), _cfg(tarch2.Arch2Config, num_layers=2)
    jparams = jax.device_get(jarch2.init_params(jax.random.PRNGKey(2), jcfg))
    tflat, jflat = tckpt.arch2_to_flat(jparams), jckpt.arch2_to_flat(jparams)
    assert sorted(tflat) == sorted(jflat) == ["cnn_w", "encoder_w_q", "multimodal_w"]
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k])
    # the port writes, the JAX package reads
    tparams = arch2_params_to_numpy(tarch2.init_params(tcfg, torch.Generator().manual_seed(2), "cpu"))
    tckpt.save_flat_h5(str(tmp_path / "t.h5"), tckpt.arch2_to_flat(tparams))
    back = jckpt.arch2_from_flat(jckpt.load_flat_h5(str(tmp_path / "t.h5")), jcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tparams)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the JAX package writes, the port reads
    jckpt.save_flat_h5(str(tmp_path / "j.h5"), jflat)
    back = tckpt.arch2_from_flat(tckpt.load_flat_h5(str(tmp_path / "j.h5")), tcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="encoder_w_q"):
        tckpt.arch2_from_flat(jflat, tcfg._replace(vocab_size=V + 1))


def test_train_step_indexed_matches_jax():
    """One rmsprop step (weight decay 1e-4, clamp 10) at dropout 0."""
    jcfg = _cfg(jarch2.Arch2Config, num_layers=2, dropout=0.0)
    tcfg = _cfg(tarch2.Arch2Config, num_layers=2, dropout=0.0)
    params = jax.device_get(jarch2.init_params(jax.random.PRNGKey(4), jcfg))
    tokens, image = _inputs(4, n=20)
    rs = np.random.RandomState(5)
    data = {"tokens": tokens, "image": image, "img_pos": rs.randint(1, 21, size=20).astype(np.int32),
            "answers": rs.randint(1, N_ANS + 1, size=20).astype(np.int32)}
    qinds = rs.randint(0, 20, size=8).astype(np.int32)

    jtx = jarch2.make_optimizer(learning_rate=1e-3)
    jp, _, jloss = jarch2.train_step_indexed(
        jcfg, jtx, jax.tree_util.tree_map(jnp.asarray, params), jtx.init(params),
        {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(qinds), jax.random.PRNGKey(0))
    ttx = tarch2.make_optimizer(learning_rate=1e-3)
    tp0 = arch2_params_from_numpy(params, "cpu")
    tp, _, tloss = tarch2.train_step_indexed(
        tcfg, ttx, tp0, ttx.init(tp0), {k: torch.from_numpy(v) for k, v in data.items()},
        torch.from_numpy(qinds).long(), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    ref = tckpt._flatten_tree(jax.device_get(jp))
    got = tckpt._flatten_tree(tp)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)


def test_score_margins_leave_no_near_tie(files):
    """Guard for the byte-identity test: two frameworks sum in different
    orders, so a top-2 margin under 1e-4 could flip an argmax."""
    d = files
    data = VQAData(d["ques_h5"], d["img_h5"], d["meta"], load_test=True, align="left")
    store = data.split_store("test")
    with torch.inference_mode():
        scores = tarch2.apply(
            arch2_params_from_numpy(d["params"], "cpu"), _cfg(tarch2.Arch2Config),
            torch.from_numpy(store["tokens"]), torch.from_numpy(store["image"][store["img_pos"] - 1]),
        ).numpy()
    top2 = np.sort(scores, axis=1)[:, -2:]
    assert np.min(top2[:, 1] - top2[:, 0]) > 1e-4
    for row, choices in zip(scores, store["mc_ans"]):
        valid = np.sort(row[choices[choices != 0] - 1])
        assert valid[-1] - valid[-2] > 1e-4


def test_eval_cli_json_byte_identical_to_jax_and_across_store_modes(files):
    d = files
    outs = {}
    jeval.main(_eval_argv(d, str(d["tmp"] / "jax_1") + "/", d["model_h5"]))
    for hbm in (1, 0):
        out = str(d["tmp"] / f"torch_{hbm}") + "/"
        teval.main(_eval_argv(d, out, d["model_h5"], hbm) + ["--device", "cpu"])
        outs[hbm] = {n: open(out + n, "rb").read() for n in NAMES}
    ref = {n: open(str(d["tmp"] / "jax_1") + "/" + n, "rb").read() for n in NAMES}
    assert outs[1] == ref
    assert outs[0] == ref
    assert len(json.loads(ref[NAMES[0]])) == N_TEST


def test_streaming_pad_is_the_last_row(files):
    """Both store modes of the port give the same scores; padding the final
    batch with row 0, as the JAX package's streaming path does, changes the
    real rows' scores there."""
    d = files
    data = VQAData(d["ques_h5"], d["img_h5"], d["meta"], load_test=True, align="left")
    params = arch2_params_from_numpy(d["params"], "cpu")
    tcfg = _cfg(tarch2.Arch2Config)
    scores = {hbm: run_full_split(tarch2, tcfg, params, data, "test", BATCH, device="cpu",
                                  hbm_resident=bool(hbm), want="scores")[2] for hbm in (1, 0)}
    np.testing.assert_array_equal(scores[0], scores[1])
    assert d["test_lens"][0] > d["test_lens"][32:].max()

    store = data.split_store("test")
    jcfg = _cfg(jarch2.Arch2Config)
    real = np.arange(32, N_TEST)
    out = {}
    for pad in (0, N_TEST - 1):
        rows = np.concatenate([real, np.full(BATCH - len(real), pad)])
        out[pad] = np.asarray(jarch2.apply(d["params"], jcfg, jnp.asarray(store["tokens"][rows]),
                                           jnp.asarray(store["image"][store["img_pos"][rows] - 1])))
    np.testing.assert_allclose(scores[1][real], out[N_TEST - 1][: len(real)], **TOL)
    assert np.abs(out[0][: len(real)] - out[N_TEST - 1][: len(real)]).max() > 1e-4


def test_train_then_eval_cli(files, tmp_path):
    """The port's trainer on the split (iteration and dispatch cadences of
    the JAX CLI), its lstm.h5 read by the JAX package, the port's eval on
    it, and ``--dump_scores_h5`` into a file h5py wrote, whose other
    datasets stay."""
    d = files
    # the JAX trainer's cadence: a checkpoint before the first step and
    # wherever a dispatch's window reaches a multiple of 5
    saved_at = {1: (1, 5, 10), 5: (1, 6)}
    for spd in (1, 5):
        ckpt = str(tmp_path / f"model_{spd}") + "/"
        ttrain.main(_data_argv(d) + [
            "--checkpoint_path", ckpt, "--batch_size", "50", "--max_iters", "10",
            "--save_checkpoint_every", "5", "--learning_rate", "3e-3", "--log_every", "5",
            "--steps_per_dispatch", str(spd), "--device", "cpu"])
        with open(ckpt + "save/logFile.txt") as f:
            emas = [float(ln.split()[2]) for ln in f if ln.startswith("training loss:")]
        assert len(emas) == 2 and np.isfinite(emas).all()
        assert sorted(os.listdir(ckpt + "save")) == sorted(
            ["logFile.txt", "logFileVal.txt", "train_metrics.jsonl"]
            + [f"lstm_save_iter{k}.{ext}" for k in saved_at[spd] for ext in ("h5", "npz")])
    with h5py.File(ckpt + "lstm.h5", "r") as f:
        assert set(f.keys()) == {"cnn_w", "encoder_w_q", "multimodal_w"}
    jckpt.arch2_from_flat(jckpt.load_flat_h5(ckpt + "lstm.h5"), _cfg(jarch2.Arch2Config))

    scores_h5 = str(tmp_path / "scores.h5")
    with h5py.File(scores_h5, "w") as f:
        f.create_dataset("OtherTest", data=np.arange(6, dtype=np.float32).reshape(2, 3))
    out = str(tmp_path / "result") + "/"
    scores, _ = teval.main(_eval_argv(d, out, ckpt + "lstm.h5") + [
        "--dump_scores_h5", scores_h5, "--device", "cpu"])
    assert sorted(os.listdir(out)) == sorted(NAMES)
    with h5py.File(scores_h5, "r") as f:
        assert sorted(f.keys()) == ["OtherTest", "OutTest"]
        np.testing.assert_array_equal(f["OtherTest"][()], np.arange(6, dtype=np.float32).reshape(2, 3))
        np.testing.assert_array_equal(f["OutTest"][()], scores)
    with open(str(tmp_path / "bad.h5"), "wb") as f:
        f.write(b"not an hdf5 file")
    with pytest.raises(ValueError, match="HDF5"):
        teval.main(_eval_argv(d, out, ckpt + "lstm.h5") + [
            "--dump_scores_h5", str(tmp_path / "bad.h5"), "--device", "cpu"])


def test_init_from_takes_a_jax_ae_npz(files, tmp_path):
    d = files
    ae_cfg = jae.AEConfig(vocab_size=V, input_encoding_size=E, rnn_size=H, seq_length=D, variant="arch2")
    ae_params = jax.device_get(jae.init_params(jax.random.PRNGKey(9), ae_cfg))
    jckpt.save_npz(str(tmp_path / "ae.npz"), ae_params, meta={"cfg": ae_cfg._asdict()})
    cnn = {"cnn_proj": {"w": np.full((F, E), 0.01, np.float32), "b": np.zeros(E, np.float32)}}
    jckpt.save_npz(str(tmp_path / "cnn.npz"), cnn)
    ckpt = str(tmp_path / "model") + "/"
    base = _data_argv(d) + ["--checkpoint_path", ckpt, "--batch_size", "50", "--max_iters", "1",
                            "--init_from", str(tmp_path / "ae.npz"), "--device", "cpu"]
    ttrain.main(base + ["--cnn_proj_init", str(tmp_path / "cnn.npz")])
    flat, _ = tckpt.load_npz(ckpt + "save/lstm_save_iter1.npz")  # written before the first step
    np.testing.assert_array_equal(flat["lookup"], ae_params["lookup"])
    for p in ("wx", "bx", "wh", "bh"):
        np.testing.assert_array_equal(flat[f"encoder/0/{p}"], ae_params["encoder"][0][p])
    np.testing.assert_array_equal(flat["cnn_proj/w"], cnn["cnn_proj"]["w"])
    with pytest.raises(ValueError, match="encoder layers"):
        ttrain.main(base + ["--num_layers", "2"])


def test_clis_refuse_data_parallel_and_a_missing_card(files, tmp_path):
    """Without a card the default device raises, with and without
    ``--data_parallel 1`` (DP never falls back to the CPU); on the CPU a
    DP run in one process writes what the plain run writes."""
    d = files
    train_argv = _data_argv(d) + ["--checkpoint_path", str(tmp_path) + "/", "--max_iters", "1"]
    eval_argv = _eval_argv(d, str(tmp_path) + "/", d["model_h5"])
    for main, argv in ((ttrain.main, train_argv), (teval.main, eval_argv)):
        if not torch.cuda.is_available():
            for extra in ([], ["--data_parallel", "1"]):
                with pytest.raises(RuntimeError, match="cuda"):
                    main(argv + extra)  # the default device is cuda
        main(argv + ["--device", "cpu", "--data_parallel", "1"])
    assert (tmp_path / "lstm.h5").exists()


def test_params_land_on_the_requested_device():
    tcfg = _cfg(tarch2.Arch2Config)
    params = tarch2.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(params))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tarch2.init_params(tcfg, torch.Generator().manual_seed(0))
