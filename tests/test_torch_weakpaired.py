"""The port's weak-paired trainer (joint CNN + AE) and the mean-vector tool
against the JAX package's, on the CPU: the loader and the crop, one train
step per (variant, finetune phase) and trunk, the validation NLL, the CLI
end to end (checkpoints, ``--resume``, ``--start_from_text``, the
refusals), and ``compute_mean_vectors``.

The same numpy params go to both packages (the port's init, carried by
``core/convert.py``; conv weights HWIO on the JAX side), the same crops and
tokens.  Dropout masks cannot match bit for bit, so the train steps run
with every dropout the identity on both sides, as in
``tests/test_torch_autoencoder.py``; they take sgd so that the update is the
gradient times the learning rate.  Tolerances: loss and validation NLL
1e-5; updated params 1e-5 of max |JAX| per leaf (2.5e-6 seen) and their
updates 1e-3 of max |JAX update| (1.6e-4 seen: the two frameworks sum the
convolutions' gradients in other orders); the mean LSTM vector 1e-5;
loader batches, crops and the mean image vector exact.  The Inception
trunk's cases are in ``test_torch_weakpaired_inception.py``."""

import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novel_vqa_tpu.data import weakpaired as jwp
from novel_vqa_tpu.models.seq import autoencoder as jae
from novel_vqa_tpu.models.vision import inception as jinc
from novel_vqa_tpu.ops import fusion as jfusion
from novel_vqa_tpu.train import compute_mean_vectors as jmean
from novel_vqa_tpu.train import train_weakpaired_ae as jtrain
from novel_vqa_torch.core.checkpoint import _flatten_tree, load_npz, save_npz
from novel_vqa_torch.core.convert import ae_params_to_numpy, vision_params_to_numpy
from novel_vqa_torch.core.h5 import H5Reader, write_h5
from novel_vqa_torch.core.tree import tree_leaves
from novel_vqa_torch.data import weakpaired as twp
from novel_vqa_torch.models.seq import autoencoder as tae
from novel_vqa_torch.ops import fusion as tfusion
from novel_vqa_torch.train import compute_mean_vectors as tmean
from novel_vqa_torch.train import train_text_ae as ttext
from novel_vqa_torch.train import train_weakpaired_ae as ttrain

V, L, E, N = 30, 5, 16, 4
N_TRAIN, N_VAL = 14, 6
TRUNKS = {"vgg16": {"side": 40, "crop": 32, "nhimage": 4096},
          "inception": {"side": 80, "crop": 75, "nhimage": 2048}}
PARAM_TOL, UPDATE_TOL = 1e-5, 1e-3


def _labels(rs, n):
    labels = np.zeros((n, L), np.uint32)
    for i, ln in enumerate(rs.randint(1, L + 1, size=n)):
        labels[i, :ln] = rs.randint(1, V + 1, size=ln)
    return labels


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Per trunk a corpus h5 (``labels/*`` and CHW uint8 ``images/*``,
    written by h5py) and its json; a mean LSTM vector h5 (2H wide)."""
    tmp = tmp_path_factory.mktemp("wp")
    rs = np.random.RandomState(0)
    out = {}
    for trunk, spec in TRUNKS.items():
        side = spec["side"]
        h5_path = str(tmp / f"{trunk}.h5")
        with h5py.File(h5_path, "w") as f:
            for split, n in (("train", N_TRAIN), ("val", N_VAL), ("test", N_VAL)):
                f.create_dataset(f"labels/{split}", dtype="uint32", data=_labels(rs, n))
                f.create_dataset(f"images/{split}", dtype="uint8",
                                 data=rs.randint(0, 256, (n, 3, side, side), dtype=np.uint8))
        out[trunk] = h5_path
    out["json"] = str(tmp / "data.json")
    with open(out["json"], "w") as f:
        json.dump({"ix_to_word": {str(i): f"w{i}" for i in range(1, V + 1)},
                   "num_train": N_TRAIN, "num_val": N_VAL, "num_test": N_VAL}, f)
    out["mean"] = str(tmp / "lstm_mean.h5")
    write_h5(out["mean"], {"mean_vector": rs.randn(1, 2 * E).astype(np.float32)})
    return out


def test_loader_batches_and_wrap_match_jax(corpora):
    jl = jwp.WeakPairedLoader(corpora["vgg16"], corpora["json"])
    tl = twp.WeakPairedLoader(corpora["vgg16"], corpora["json"])
    try:
        for split, bs in (("train", 5), ("train", 5), ("train", 5), ("train", 3), ("val", 6), ("val", 6),
                          ("train", 13), ("train", 13)):
            jb, tb = jl.get_batch_with_images(split, bs), tl.get_batch_with_images(split, bs)
            np.testing.assert_array_equal(tb[0], jb[0])
            np.testing.assert_array_equal(tb[1], jb[1])
            assert tb[1].shape == (bs, 40, 40, 3) and tb[1].dtype == np.uint8 and tb[0].dtype == np.int32
            assert tb[2] == jb[2]
    finally:
        jl.close()
        tl.close()


def test_crop_offsets_and_prepro_match_jax():
    rs = np.random.RandomState(1)
    u8 = rs.randint(0, 256, (3, 12, 10, 3), dtype=np.uint8)
    offsets = np.array([[0, 0], [4, 2], [2, 3]], np.int32)
    ref = np.asarray(jwp.prepro_wp_images(jnp.asarray(u8), jnp.asarray(offsets), 7))
    got = twp.prepro_wp_images(torch.from_numpy(u8), torch.from_numpy(offsets), 7)
    assert got.shape == (3, 3, 7, 7) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    np.testing.assert_array_equal(twp.center_crop_offsets(3, 256, 224), jwp.center_crop_offsets(3, 256, 224))
    np.testing.assert_array_equal(twp.random_crop_offsets(np.random.default_rng(5), 50, 256, 224),
                                  jwp.random_crop_offsets(np.random.default_rng(5), 50, 256, 224))


def _identity_dropouts(monkeypatch):
    monkeypatch.setattr(jae, "dropout", lambda rng, x, rate, deterministic: x)
    monkeypatch.setattr(jfusion, "dropout", lambda rng, x, rate, deterministic: x)
    monkeypatch.setattr(tae, "dropout", lambda x, rate, generator, deterministic: x)
    monkeypatch.setattr(tfusion, "dropout", lambda x, rate, generator, deterministic: x)


def _cheap_jax_inception(monkeypatch):
    """``jtrain.build_cnn`` draws an Inception tree with ``jax.random`` per
    unit (seconds on the CPU) that the tests replace: draw zeros."""
    monkeypatch.setattr(jinc, "_cbr_init", lambda rng, kh, kw, c_in, c_out: {
        "conv": {"w": np.zeros((kh, kw, c_in, c_out), np.float32)},
        "bn": {k: np.zeros(c_out, np.float32) for k in ("scale", "offset", "mean", "var")}})
    monkeypatch.setattr(jinc, "linear_init", lambda rng, n_in, n_out: {
        "w": np.zeros((n_in, n_out), np.float32), "b": np.zeros(n_out, np.float32)})


def _setup(trunk, variant, monkeypatch, **flags):
    """Both packages' step pieces on the same params: (jax cfg, port cfg,
    jax ae/cnn numpy trees, port ae/cnn trees, jax cnn_apply, port
    cnn_apply, both options)."""
    spec = TRUNKS[trunk]
    kw = dict(cnn_arch=trunk, variant=variant, rnn_size=E, input_encoding_size=E, batch_size=N,
              image_size=spec["side"], crop_size=spec["crop"], nhimage=spec["nhimage"], drop_prob_ae=0.0,
              optim="sgd", cnn_optim="sgd", learning_rate=0.5, cnn_learning_rate=0.5, **flags)
    jopt, topt = jtrain.WPTrainConfig(**kw), ttrain.WPTrainConfig(device="cpu", **kw)
    tcfg = tae.AEConfig(vocab_size=V, input_encoding_size=E, rnn_size=E, seq_length=L, dropout=0.0,
                        variant=variant, nhimage=spec["nhimage"] if variant == "vqa_arch" else 0)
    jcfg = jae.AEConfig(**{k: v for k, v in tcfg._asdict().items()})
    tae_p = tae.init_params(tcfg, torch.Generator().manual_seed(2), "cpu")
    tcnn, tapply, _ = ttrain.build_cnn(topt, variant == "null", torch.Generator().manual_seed(3), "cpu")
    if trunk == "inception":
        _cheap_jax_inception(monkeypatch)
    _, japply, _ = jtrain.build_cnn(jopt, variant == "null", jax.random.PRNGKey(0))
    return (jcfg, tcfg, ae_params_to_numpy(tae_p), vision_params_to_numpy(tcnn), tae_p, tcnn,
            japply, tapply, jopt, topt)


def _batch(trunk, variant, zero_input, rs):
    spec = TRUNKS[trunk]
    images = rs.randint(0, 256, (N, spec["side"], spec["side"], 3), dtype=np.uint8)
    offsets = twp.random_crop_offsets(np.random.default_rng(7), N, spec["side"], spec["crop"])
    seq = _labels(rs, N).T.astype(np.int32).copy()
    sent_input = np.zeros((N, 2 * E), np.float32)
    seq_input = seq
    skip = False
    if variant == "vqa_arch" and zero_input:  # the mean-vector path
        skip, sent_input = True, np.tile(rs.randn(2 * E).astype(np.float32), (N, 1))
    elif variant == "null" and zero_input:  # --rand_val's zeroing
        seq_input = np.zeros_like(seq)
    return skip, images, offsets, seq, sent_input, seq_input


# one step per (variant, finetune phase), each taking one of the variant's
# input paths: vqa_arch's mean-vector skip, null's zeroed encoder input
STEP_CASES = [(v, ft) for v in ("vqa_arch", "null") for ft in (False, True)]


def check_train_step(trunk, variant, finetune, monkeypatch):
    _identity_dropouts(monkeypatch)
    flags = {"cnn_weight_decay": 1e-3} if finetune else {}  # the cnn chain's decay and clamp
    jcfg, tcfg, j_ae, j_cnn, t_ae, t_cnn, japply, tapply, jopt, topt = _setup(trunk, variant, monkeypatch, **flags)
    rs = np.random.RandomState(8)
    skip, images, offsets, seq, sent_input, seq_input = _batch(trunk, variant, not finetune, rs)
    crop = TRUNKS[trunk]["crop"]

    j_ae_tx, j_cnn_tx = jtrain.make_ae_tx(jopt), jtrain.make_cnn_tx(jopt)
    jstep = jtrain.make_train_step(jcfg, variant, crop, japply, j_ae_tx, j_cnn_tx)
    j_out = jstep(skip, finetune, j_ae, j_ae_tx.init(j_ae), j_cnn, j_cnn_tx.init(j_cnn),
                  jnp.asarray(images), jnp.asarray(offsets), jnp.asarray(seq), jnp.asarray(sent_input),
                  jnp.asarray(seq_input), jax.random.PRNGKey(0))
    t_ae_tx, t_cnn_tx = ttrain.make_ae_tx(topt), ttrain.make_cnn_tx(topt)
    tstep = ttrain.make_train_step(tcfg, variant, crop, tapply, t_ae_tx, t_cnn_tx)
    t_out = tstep(skip, finetune, t_ae, t_ae_tx.init(t_ae), t_cnn, t_cnn_tx.init(t_cnn),
                  *(torch.from_numpy(a) for a in (images, offsets, seq, sent_input, seq_input)),
                  torch.Generator().manual_seed(0))

    np.testing.assert_allclose(float(t_out[4]), float(j_out[4]), rtol=1e-5, atol=1e-5)
    for name, got, ref, before in (("ae", ae_params_to_numpy(t_out[0]), jax.device_get(j_out[0]), j_ae),
                                   ("cnn", vision_params_to_numpy(t_out[2]), jax.device_get(j_out[2]), j_cnn)):
        got, ref, before = _flatten_tree(got), _flatten_tree(ref), _flatten_tree(before)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert np.abs(got[k] - ref[k]).max() <= PARAM_TOL * np.abs(ref[k]).max(), (name, k)
            upd_ref, upd_got = ref[k] - before[k], got[k] - before[k]
            assert np.abs(upd_got - upd_ref).max() <= UPDATE_TOL * np.abs(upd_ref).max(), (name, k)
        if name == "cnn":
            moved = [k for k in ref if np.abs(got[k] - before[k]).max() > 0]
            assert bool(moved) == finetune  # with finetune off the CNN is unchanged


@pytest.mark.parametrize("variant,finetune", STEP_CASES)
def test_train_step_matches_jax(variant, finetune, monkeypatch):
    check_train_step("vgg16", variant, finetune, monkeypatch)


def check_val_step(trunk, variant, monkeypatch):
    jcfg, tcfg, j_ae, j_cnn, t_ae, t_cnn, japply, tapply, jopt, topt = _setup(trunk, variant, monkeypatch)
    _, images, offsets, seq, _, _ = _batch(trunk, variant, False, np.random.RandomState(9))
    spec = TRUNKS[trunk]
    offsets = twp.center_crop_offsets(N, spec["side"], spec["crop"])

    @jax.jit
    def ref_nll(j_ae, j_cnn, images, offsets, seq):  # the JAX CLI's val_step
        feats = japply(j_cnn, jwp.prepro_wp_images(images, offsets, spec["crop"]))
        if variant == "vqa_arch":
            return jae.apply_nll(j_ae, jcfg, seq, imgs=feats, sent_input=jnp.zeros((N, 2 * E)),
                                 encoder_skip=False, deterministic=True)[0]
        return jae.apply_nll(j_ae, jcfg, seq, imgs=feats, seq_input=seq, deterministic=True)[0]

    ref = ref_nll(j_ae, j_cnn, jnp.asarray(images), jnp.asarray(offsets), jnp.asarray(seq))
    got = ttrain.val_step(tcfg, variant, spec["crop"], tapply, t_ae, t_cnn, torch.from_numpy(images),
                          torch.from_numpy(offsets), torch.from_numpy(seq))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["vqa_arch", "null"])
def test_val_step_matches_jax(variant, monkeypatch):
    check_val_step("vgg16", variant, monkeypatch)


def test_bf16_trunk_keeps_f32_masters(monkeypatch):
    """``--compute_dtype bfloat16``: the trunk runs in bf16 storage inside
    the step; the masters, their update and the features stay f32, and the
    loss is within the bf16 bound (1e-2) of the f32 step's."""
    _identity_dropouts(monkeypatch)
    losses = {}
    for dtype in ("float32", "bfloat16"):
        _, tcfg, _, _, t_ae, t_cnn, _, tapply, _, topt = _setup("vgg16", "null", monkeypatch, compute_dtype=dtype)
        _, images, offsets, seq, sent_input, seq_input = _batch("vgg16", "null", False, np.random.RandomState(10))
        ae_tx, cnn_tx = ttrain.make_ae_tx(topt), ttrain.make_cnn_tx(topt)
        step = ttrain.make_train_step(tcfg, "null", 32, tapply, ae_tx, cnn_tx)
        out = step(False, True, t_ae, ae_tx.init(t_ae), t_cnn, cnn_tx.init(t_cnn),
                   *(torch.from_numpy(a) for a in (images, offsets, seq, sent_input, seq_input)),
                   torch.Generator().manual_seed(0))
        assert all(t.dtype == torch.float32 for t in tree_leaves(out[2]))
        losses[dtype] = float(out[4])
    assert abs(losses["bfloat16"] - losses["float32"]) <= 1e-2 * abs(losses["float32"])


def _cli_args(corpora, trunk, variant, ckpt, *extra):
    spec = TRUNKS[trunk]
    args = ["--input_h5", corpora[trunk], "--input_json", corpora["json"], "--variant", variant,
            "--cnn_arch", trunk, "--rnn_size", str(E), "--input_encoding_size", str(E), "--batch_size", str(N),
            "--image_size", str(spec["side"]), "--crop_size", str(spec["crop"]), "--nhimage", str(spec["nhimage"]),
            "--val_sentences_use", str(N), "--losses_log_every", "1", "--checkpoint_path", ckpt,
            "--device", "cpu", *extra]
    if variant == "vqa_arch":
        args += ["--lstm_average_path", corpora["mean"]]
    return args


def check_cli_resumes(corpora, trunk, variant, tmp_path):
    ckpt = str(tmp_path / "wp")
    ttrain.main(_cli_args(corpora, trunk, variant, ckpt, "--max_iters", "3", "--finetune_cnn_after", "1",
                          "--save_checkpoint_every", "2", "--save_train_state", "1"))
    with open(os.path.join(ckpt, "model_id.json")) as f:
        log = json.load(f)
    assert log["iter"] == 2 and sorted(log["loss_history"]) == ["0", "1", "2"]
    assert sorted(log["val_loss_history"]) == ["0", "2"]
    assert np.isfinite(list(log["loss_history"].values()) + list(log["val_loss_history"].values())).all()
    flat, meta = load_npz(os.path.join(ckpt, "model_id.npz"))
    assert meta["cfg"]["variant"] == variant and {k.split("/")[0] for k in flat} == {"ae", "cnn"}
    first_conv = "cnn/trunk/conv/0/w" if trunk == "vgg16" else "cnn/trunk/stem/c1/conv/w"
    assert flat[first_conv].shape == (3, 3, 3, 64 if trunk == "vgg16" else 32)  # HWIO, as JAX writes
    assert ("cnn/proj/w" in flat) == (variant == "null")
    state, smeta = load_npz(os.path.join(ckpt, "train_state.npz"))
    assert smeta["iter"] == 2 and {k.split("/")[0] for k in state} == {"ae", "cnn", "ae_opt", "cnn_opt"}
    ttrain.main(_cli_args(corpora, trunk, variant, ckpt, "--max_iters", "5", "--finetune_cnn_after", "1",
                          "--save_checkpoint_every", "2", "--resume", os.path.join(ckpt, "train_state.npz")))
    with open(os.path.join(ckpt, "model_id.json")) as f:
        log = json.load(f)
    assert log["iter"] == 4 and sorted(log["loss_history"]) == ["3", "4"]


@pytest.mark.parametrize("variant", ["vqa_arch", "null"])
def test_cli_writes_checkpoints_and_resumes(corpora, variant, tmp_path):
    """Both finetune phases, a checkpoint in the JAX CLI's keys, then
    ``--resume`` continues from the train state."""
    check_cli_resumes(corpora, "vgg16", variant, tmp_path)


def test_cli_checkpoint_keys_are_the_jax_cli_keys(corpora, tmp_path):
    """The port's model_id.npz has the keys and shapes of the JAX trainer's
    trees, so the JAX package's ``unflatten_like`` reads it."""
    from novel_vqa_tpu.core.checkpoint import _flatten_tree as jflatten

    ckpt = str(tmp_path / "wp")
    ttrain.main(_cli_args(corpora, "vgg16", "null", ckpt, "--max_iters", "1"))
    flat, _ = load_npz(os.path.join(ckpt, "model_id.npz"))
    spec = TRUNKS["vgg16"]
    jopt = jtrain.WPTrainConfig(variant="null", rnn_size=E, input_encoding_size=E, crop_size=spec["crop"])
    jcnn, _, _ = jtrain.build_cnn(jopt, True, jax.random.PRNGKey(0))
    jcfg = jae.AEConfig(vocab_size=V, input_encoding_size=E, rnn_size=E, seq_length=L, variant="null")
    ref = jflatten({"ae": jax.device_get(jae.init_params(jax.random.PRNGKey(0), jcfg)),
                    "cnn": jax.device_get(jcnn)})
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ref.items()}


def test_cli_start_from_text_loads_a_port_text_ae(corpora, tmp_path):
    """A text-AE checkpoint of ``train_text_ae`` seeds the lookup, encoder
    and decoder (at learning rate 0 the saved AE is the text AE)."""
    text = str(tmp_path / "text")
    ttext.main(["--input_h5", corpora["vgg16"], "--input_json", corpora["json"], "--rnn_size", str(E),
                "--input_encoding_size", str(E), "--batch_size", str(N), "--max_iters", "1",
                "--val_sentences_use", str(N), "--checkpoint_path", text, "--device", "cpu"])
    ckpt = str(tmp_path / "wp")
    ttrain.main(_cli_args(corpora, "vgg16", "vqa_arch", ckpt, "--max_iters", "1", "--learning_rate", "0",
                          "--start_from_text", os.path.join(text, "model_id.npz")))
    src, _ = load_npz(os.path.join(text, "model_id.npz"))
    got, _ = load_npz(os.path.join(ckpt, "model_id.npz"))
    keys = [k for k in src if k.startswith(("lookup", "encoder/", "decoder/"))]
    assert len(keys) == 1 + 4 + 4 + 2
    for k in keys:
        np.testing.assert_array_equal(got["ae/" + k], src[k])


@pytest.mark.parametrize("flag,item", [("--data_parallel", "A13"), ("--remat", "A11")])
def test_cli_refuses_what_is_not_ported(corpora, tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ttrain.main(_cli_args(corpora, "vgg16", "null", str(tmp_path), flag, "1"))


def test_cli_defaults_to_the_card(corpora, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = _cli_args(corpora, "vgg16", "null", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(args[: args.index("--device")] + args[args.index("--device") + 2:])


@pytest.mark.parametrize("batch", [4, 5])  # 14 sentences: the last batch wraps at both
def test_mean_lstm_vector_matches_jax(corpora, tmp_path, batch):
    """On a weak-paired checkpoint (``ae/`` keys, vqa_arch's encoder)
    written by the port: each sentence counted once across the wrap."""
    ckpt = str(tmp_path / "wp")
    ttrain.main(_cli_args(corpora, "vgg16", "vqa_arch", ckpt, "--max_iters", "1"))
    argv = ["lstm", "--ae_model", os.path.join(ckpt, "model_id.npz"), "--input_h5", corpora["vgg16"],
            "--input_json", corpora["json"], "--batch_size", str(batch)]
    jmean.main(argv + ["--out", str(tmp_path / "j.h5")])
    tmean.main(argv + ["--out", str(tmp_path / "t.h5"), "--device", "cpu"])
    with h5py.File(tmp_path / "j.h5", "r") as j, H5Reader(str(tmp_path / "t.h5")) as t:
        assert t.keys() == ["mean_vector"] and t["mean_vector"].shape == (1, 2 * E)
        np.testing.assert_allclose(t["mean_vector"], j["mean_vector"][()], rtol=1e-5, atol=1e-5)


def test_mean_lstm_vector_counts_each_sentence_once(corpora, tmp_path):
    """The mean over the loader's windows of 4 (rows 0-3, 4-7, 8-11, then
    12-13 and the head re-read), each of the 14 sentences once.  (A row's
    encoding depends on its batch: the encoder skips a step only when every
    row of the batch is null there.)"""
    tcfg = tae.AEConfig(vocab_size=V, input_encoding_size=E, rnn_size=E, seq_length=L)
    params = tae.init_params(tcfg, torch.Generator().manual_seed(4), "cpu")
    save_npz(str(tmp_path / "ae.npz"), ae_params_to_numpy(params), meta={"cfg": tcfg._asdict()})
    tmean.main(["lstm", "--ae_model", str(tmp_path / "ae.npz"), "--input_h5", corpora["vgg16"],
                "--input_json", corpora["json"], "--batch_size", "4", "--out", str(tmp_path / "m.h5"),
                "--device", "cpu"])
    with h5py.File(corpora["vgg16"], "r") as f:
        rows = f["labels/train"][()].astype(np.int32)
    vecs = []
    for window, keep in ((rows[0:4], 4), (rows[4:8], 4), (rows[8:12], 4),
                         (np.concatenate([rows[12:14], rows[0:2]]), 2)):
        with torch.inference_mode():
            c, h = tae.encode(params, tcfg, torch.from_numpy(window.T.copy()))
        vecs.append(torch.cat([c[-1], h[-1]], dim=-1)[:keep].double())
    ref = torch.cat(vecs).mean(0).float().numpy()
    with H5Reader(str(tmp_path / "m.h5")) as t:
        np.testing.assert_allclose(t["mean_vector"][0], ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("l2", [0, 1])
def test_mean_image_vector_matches_jax_exactly(tmp_path, l2):
    feats = np.random.RandomState(11).rand(9, 7).astype(np.float32)
    with h5py.File(tmp_path / "img.h5", "w") as f:
        f.create_dataset("images_train", data=feats)
    argv = ["image", "--input_img_h5", str(tmp_path / "img.h5"), "--l2_normalize", str(l2)]
    jmean.main(argv + ["--out", str(tmp_path / "j.h5")])
    tmean.main(argv + ["--out", str(tmp_path / "t.h5")])
    with h5py.File(tmp_path / "j.h5", "r") as j, h5py.File(tmp_path / "t.h5", "r") as t:
        np.testing.assert_array_equal(t["mean_vector"][()], j["mean_vector"][()])
        assert t["mean_vector"].dtype == np.float32 and t["mean_vector"].shape == (1, 7)
