"""The port's arch1 training (dropout, optimizer, loss, steps, trainer CLI,
checkpoints) against the JAX package.  Inputs come from numpy seeds; the
models are tiny.  Tolerances: 1e-6 on optimizer updates (the same f32
arithmetic), 1e-5 on the loss and its gradients and on params after a
step (different f32 summation orders); files and keys exact."""

import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novel_vqa_tpu.core import checkpoint as jckpt
from novel_vqa_tpu.models.vqa import arch1 as jarch1
from novel_vqa_tpu.train import eval_vqa_arch1 as jeval
from novel_vqa_tpu.train import train_vqa_arch1 as jtrain

from novel_vqa_torch.core import checkpoint as tckpt
from novel_vqa_torch.core.convert import arch1_params_from_numpy, arch1_params_to_numpy
from novel_vqa_torch.core.tree import tree_leaves, tree_map, value_and_grad
from novel_vqa_torch.models.vqa import arch1 as tarch1
from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.train import eval_vqa_arch1 as teval
from novel_vqa_torch.train import train_vqa_arch1 as ttrain

TOL = dict(rtol=1e-5, atol=1e-5)
V, D, N_ANS, F = 15, 4, 3, 8
WIDTHS = dict(nhimage=F, input_encoding_size=8, rnn_size=10, rnn_layer=2,
              common_embedding_size=8, num_output=N_ANS)


def _cfgs(dropout_rate=0.0, fusion="axb"):
    kw = dict(vocab_size=V, fusion=fusion, dropout=dropout_rate, **WIDTHS)
    return jarch1.Arch1Config(**kw), tarch1.Arch1Config(**kw)


def _np_params(jcfg, seed=0):
    return jax.device_get(jarch1.init_params(jax.random.PRNGKey(seed), jcfg))


def _batch(n, seed):
    rs = np.random.RandomState(seed)
    tokens = np.zeros((n, D), np.int32)
    for i in range(n):
        length = rs.randint(1, D + 1)
        tokens[i, D - length:] = rs.randint(1, V + 1, size=length)
    image = rs.randn(n, F).astype(np.float32)
    image /= np.linalg.norm(image, axis=1, keepdims=True)
    labels = rs.randint(1, N_ANS + 1, size=n).astype(np.int32)
    return tokens, image, labels


def _close_trees(got, ref, **tol):
    """Leaf by leaf, matched by tree path (the npz keys)."""
    got_f, ref_f = tckpt._flatten_tree(got), jckpt._flatten_tree(jax.device_get(ref))
    assert sorted(got_f) == sorted(ref_f)
    for k, b in ref_f.items():
        np.testing.assert_allclose(got_f[k], b, err_msg=k, **tol)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def test_dropout_identity_at_rate_zero_and_in_deterministic_mode():
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    assert dropout(x, 0.0, torch.Generator(), deterministic=False) is x
    assert dropout(x, 0.5, None, deterministic=True) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.5, None, deterministic=False)


@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_dropout_values_and_keep_fraction(rate):
    n = 200_000
    x = torch.full((n,), 3.0)
    y = dropout(x, rate, torch.Generator().manual_seed(1), deterministic=False)
    keep = 1.0 - rate
    assert set(torch.unique(y).tolist()) <= {0.0, 3.0 / keep}
    kept = float((y != 0).float().mean())
    assert abs(kept - keep) < 5 * np.sqrt(keep * rate / n)  # 5 sigma binomial


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scaled", [False, True])
def test_optimizer_three_updates_match_jax_chain(scaled):
    jcfg, _ = _cfgs()
    params = _np_params(jcfg)
    rs = np.random.RandomState(3)
    # grads up to ~3x the clamp of 10, so the clamp is active
    grads = [jax.tree_util.tree_map(lambda a: rs.randn(*a.shape).astype(np.float32) * 8.0, params)
             for _ in range(3)]
    kw = dict(learning_rate=3e-3, decay_factor=0.9)
    j_scales = t_scales = None
    if scaled:
        j_scales = jax.tree_util.tree_map(lambda _: 1.0, params)
        j_scales["encoder"] = jax.tree_util.tree_map(lambda _: 0.1, j_scales["encoder"])
        t_scales = tree_map(lambda _: 1.0, params)
        t_scales["encoder"] = tree_map(lambda _: 0.1, t_scales["encoder"])
    assert any(np.abs(g).max() > 10 for g in jax.tree_util.tree_leaves(grads[0]))

    jtx = jarch1.make_optimizer(grad_scales=j_scales, **kw)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = jtx.init(j_params)
    ttx = tarch1.make_optimizer(grad_scales=t_scales, **kw)
    t_params = arch1_params_from_numpy(params, "cpu")
    t_state = ttx.init(t_params)
    import optax

    j_update = jax.jit(jtx.update)
    for g in grads:
        upd, j_state = j_update(jax.tree_util.tree_map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        upd, t_state = ttx.update(arch1_params_from_numpy(g, "cpu"), t_state, t_params)
        t_params = tarch1.optim.apply_updates(t_params, upd)
    _close_trees(t_params, j_params, rtol=1e-6, atol=1e-6)
    _close_trees(t_state, j_state, rtol=1e-6, atol=1e-6)
    assert int(t_state[-1].count) == 3


# ---------------------------------------------------------------------------
# loss, one step, the multi-step loop
# ---------------------------------------------------------------------------

def test_loss_value_and_grads_match_jax_at_dropout_zero():
    jcfg, tcfg = _cfgs(dropout_rate=0.0)
    params = _np_params(jcfg, seed=1)
    tokens, image, labels = _batch(9, seed=1)
    j_loss, j_grads = jax.value_and_grad(jarch1.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg,
        jnp.asarray(tokens), jnp.asarray(image), jnp.asarray(labels), jax.random.PRNGKey(0),
    )
    t_params = arch1_params_from_numpy(params, "cpu")
    t_loss, t_grads = value_and_grad(tarch1.loss_fn)(
        t_params, tcfg, torch.from_numpy(tokens), torch.from_numpy(image),
        torch.from_numpy(labels), None,
    )
    np.testing.assert_allclose(float(t_loss), float(j_loss), **TOL)
    _close_trees(t_grads, j_grads, **TOL)
    assert not any(p.requires_grad for p in tree_leaves(t_params))


def _store(n, seed):
    tokens, _, labels = _batch(n, seed)
    rs = np.random.RandomState(seed + 100)
    return {
        "tokens": tokens,
        "image": rs.randn(6, F).astype(np.float32),
        "img_pos": rs.randint(1, 7, size=n).astype(np.int32),
        "answers": labels,
    }


def test_train_step_indexed_matches_jax_after_one_step():
    jcfg, tcfg = _cfgs(dropout_rate=0.0)
    params = _np_params(jcfg, seed=2)
    store = _store(20, seed=2)
    qinds = np.array([3, 0, 19, 7, 7, 12], np.int32)

    jtx = jarch1.make_optimizer(learning_rate=1e-2)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_params, j_state, j_loss = jarch1.train_step_indexed(
        jcfg, jtx, j_params, jtx.init(j_params),
        {k: jnp.asarray(v) for k, v in store.items()}, jnp.asarray(qinds), jax.random.PRNGKey(0),
    )
    ttx = tarch1.make_optimizer(learning_rate=1e-2)
    t_params = arch1_params_from_numpy(params, "cpu")
    t_params, t_state, t_loss = tarch1.train_step_indexed(
        tcfg, ttx, t_params, ttx.init(t_params),
        {k: torch.from_numpy(v) for k, v in store.items()}, torch.from_numpy(qinds), None,
    )
    np.testing.assert_allclose(float(t_loss), float(j_loss), **TOL)
    _close_trees(t_params, j_params, **TOL)
    _close_trees(t_state, j_state, **TOL)


def test_train_steps_scan_losses_and_reproducible_from_seed():
    _, tcfg = _cfgs(dropout_rate=0.5)
    params = arch1_params_from_numpy(_np_params(_cfgs()[0], seed=3), "cpu")
    store = {k: torch.from_numpy(v) for k, v in _store(30, seed=3).items()}
    tx = tarch1.make_optimizer(learning_rate=1e-2)

    def run(seed):
        return tarch1.train_steps_scan(
            tcfg, tx, params, tx.init(params), store, 4, 8, torch.Generator().manual_seed(seed)
        )

    p1, s1, l1 = run(5)
    p2, s2, l2 = run(5)
    _, _, l3 = run(6)
    assert l1.shape == (4,) and torch.isfinite(l1).all()
    assert torch.equal(l1, l2) and not torch.equal(l1, l3)
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        assert torch.equal(a, b)
    assert int(s1[-1].count) == 4


# ---------------------------------------------------------------------------
# the trainer CLI, files and checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A small synthetic split in the prepro schema (train, val, test); the
    answer is a function of the image."""
    tmp = tmp_path_factory.mktemp("torch_train")
    rs = np.random.RandomState(0)
    n_img = 6
    img_ans = rs.randint(1, N_ANS + 1, size=n_img)
    feats = (np.eye(N_ANS)[img_ans - 1] @ rs.randn(N_ANS, F)).astype(np.float32)

    def mk(n):
        img_pos = rs.randint(1, n_img + 1, size=n).astype(np.uint32)
        lens = rs.randint(1, D + 1, size=n).astype(np.uint32)
        q = np.zeros((n, D), np.uint32)
        for i, ln in enumerate(lens):
            q[i, :ln] = rs.randint(1, V + 1, size=ln)
        return q, lens, np.arange(1, n + 1, dtype=np.uint32), img_pos, img_ans[img_pos - 1].astype(np.uint32)

    splits = {"train": mk(80), "val": mk(20), "test": mk(20)}
    ques_h5 = str(tmp / "q.h5")
    with h5py.File(ques_h5, "w") as f:
        for name, s in splits.items():
            f.create_dataset(f"ques_{name}", dtype="uint32", data=s[0])
            f.create_dataset(f"ques_length_{name}", dtype="uint32", data=s[1])
            f.create_dataset(f"question_id_{name}", dtype="uint32", data=s[2])
            f.create_dataset(f"img_pos_{name}", dtype="uint32", data=s[3])
        f.create_dataset("answers", dtype="uint32", data=splits["train"][4])
        f.create_dataset("answers_val", dtype="uint32", data=splits["val"][4])
        mc = np.zeros((20, 18), np.uint32)
        mc[:, :N_ANS] = np.arange(1, N_ANS + 1)
        f.create_dataset("MC_ans_test", dtype="uint32", data=mc)
    img_h5 = str(tmp / "i.h5")
    with h5py.File(img_h5, "w") as f:
        for name in splits:
            f.create_dataset(f"images_{name}", dtype="float32", data=feats)
    meta = str(tmp / "m.json")
    with open(meta, "w") as f:
        json.dump({"ix_to_word": {str(i): f"w{i}" for i in range(1, V + 1)},
                   "ix_to_ans": {str(i): f"a{i}" for i in range(1, N_ANS + 1)}}, f)
    common = ["--input_img_h5", img_h5, "--input_ques_h5", ques_h5, "--input_json", meta,
              "--batch_size", "20", "--log_every", "2"]
    for k, v in WIDTHS.items():
        common += [f"--{k}", str(v)]
    return {"tmp": tmp, "common": common, "img_h5": img_h5, "ques_h5": ques_h5, "meta": meta}


RUN = ["--max_iters", "4", "--save_checkpoint_every", "2", "--save_train_state", "1"]


@pytest.fixture(scope="module")
def runs(dataset):
    """One JAX trainer run and one port trainer run on the CPU, same flags."""
    out = {}
    for name, main, extra in (("jax", jtrain.main, []), ("torch", ttrain.main, ["--device", "cpu"])):
        d = str(dataset["tmp"] / name) + "/"
        main(dataset["common"] + RUN + ["--checkpoint_path", d] + extra)
        out[name] = d
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def test_trainer_writes_the_jax_trainers_files(runs):
    assert _files(runs["torch"]) == _files(runs["jax"])
    assert "save/lstm_save_iter4.h5" in _files(runs["torch"])
    with open(runs["torch"] + "save/logFile.txt") as f:
        lines = f.read().splitlines()
    assert [ln.split("on iter: ")[1] for ln in lines] == ["2/4", "4/4"]
    assert all(np.isfinite(float(ln.split()[2])) for ln in lines)
    records = {}
    for name in ("jax", "torch"):
        with open(runs[name] + "save/train_metrics.jsonl") as f:
            records[name] = [(r["kind"], r["iter"]) for r in map(json.loads, f)]
    assert records["torch"] == records["jax"]
    assert records["torch"] == [("val", 1), ("val", 2), ("train", 2), ("val", 4), ("train", 4)]


def test_train_state_keys_match_jax(runs):
    j_flat, j_meta = jckpt.load_npz(runs["jax"] + "train_state.npz")
    t_flat, t_meta = tckpt.load_npz(runs["torch"] + "train_state.npz")
    assert sorted(t_flat) == sorted(j_flat)
    assert "opt_state/1/count" in t_flat and "opt_state/1/m/encoder/1/wh" in t_flat
    for k in j_flat:
        assert t_flat[k].shape == j_flat[k].shape and t_flat[k].dtype == j_flat[k].dtype, k
    assert t_meta["iter"] == j_meta["iter"] == 4
    assert sorted(t_meta["cfg"]) == sorted(j_meta["cfg"])


@pytest.mark.parametrize("direction", ["torch_from_jax", "jax_from_torch"])
def test_resume_crosses_packages(dataset, runs, direction):
    """Each package resumes from the other's train_state.npz: a run with
    nothing left to do writes back exactly the state it restored."""
    src, main, extra = (
        (runs["jax"], ttrain.main, ["--device", "cpu"]) if direction == "torch_from_jax"
        else (runs["torch"], jtrain.main, [])
    )
    d = str(dataset["tmp"] / direction) + "/"
    main(dataset["common"] + RUN + ["--checkpoint_path", d, "--resume", src + "train_state.npz"] + extra)
    before, _ = jckpt.load_npz(src + "train_state.npz")
    after, meta = jckpt.load_npz(d + "train_state.npz")
    assert sorted(after) == sorted(before) and meta["iter"] == 4
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])


def test_eval_clis_read_the_other_trainers_checkpoint(dataset, runs):
    for src, main, extra in ((runs["torch"], jeval.main, []), (runs["jax"], teval.main, ["--device", "cpu"])):
        out = src + "eval_other/"
        argv = ["--input_img_h5", dataset["img_h5"], "--input_ques_h5", dataset["ques_h5"],
                "--input_json", dataset["meta"], "--model_path", src + "lstm.h5",
                "--out_path", out, "--batch_size", "8"]
        for k, v in WIDTHS.items():
            argv += [f"--{k}", str(v)]
        main(argv + extra)
        for kind in ("OpenEnded", "MultipleChoice"):
            with open(f"{out}{kind}_mscoco_val2014_lstm_novel_new_2_results.json") as f:
                assert len(json.load(f)) == 20


def _opts(tmp, **kw):
    base = dict(nhimage=F, input_encoding_size=8, rnn_size=10, rnn_layer=2,
                common_embedding_size=8, num_output=N_ANS)
    base.update(kw)
    return jtrain.TrainConfig(**base), ttrain.TrainConfig(**base)


def test_start_from_and_init_from_give_the_jax_starting_params(runs, tmp_path):
    jcfg, tcfg = _cfgs(fusion="askipb")
    # --start_from: a flat h5 written by the JAX trainer
    jopt, topt = _opts(tmp_path, start_from=runs["jax"] + "lstm.h5")
    _close_trees(ttrain.build_params(topt, tcfg, "cpu"),
                 jax.device_get(jtrain.build_params(jopt, jcfg)), rtol=0, atol=0)

    # --init_from: an AE transfer h5 written by the JAX package's writer,
    # with a multimodal vector (askipb takes its projections)
    rs = np.random.RandomState(9)
    E, H, L, C = 8, 10, 2, 8
    layers = [{"wx": rs.randn(E if i == 0 else H, 4 * H), "bx": rs.randn(4 * H),
               "wh": rs.randn(H, 4 * H), "bh": rs.randn(4 * H)} for i in range(L)]
    n_mm = (2 * H * L) * C + C + F * C + C
    path = str(tmp_path / "transfer.h5")
    jckpt.ae_transfer_to_h5(path, rs.randn(V + 1, E), layers,
                            multimodal_flat=rs.randn(n_mm).astype(np.float32))
    jopt, topt = _opts(tmp_path, init_from=path, fusion="askipb")
    got = arch1_params_to_numpy(ttrain.build_params(topt, tcfg, "cpu"))
    ref = jax.device_get(jtrain.build_params(jopt, jcfg))
    for block in ("embedding", "encoder", "fusion"):
        _close_trees(got[block], ref[block], rtol=0, atol=0)
    assert not np.any(got["embedding"]["b"])


def test_trainer_scan_profile_and_anomaly_options(dataset, tmp_path):
    """--steps_per_dispatch > 1 (on-device sampling), --profile_dir (a
    torch.profiler chrome trace) and --debug_nans (detect_anomaly)."""
    d = str(tmp_path / "scan") + "/"
    prof = str(tmp_path / "prof")
    ttrain.main(dataset["common"] + [
        "--checkpoint_path", d, "--max_iters", "6", "--save_checkpoint_every", "6",
        "--steps_per_dispatch", "3", "--profile_dir", prof, "--debug_nans", "1",
        "--device", "cpu",
    ])
    assert os.path.exists(d + "lstm.h5") and os.path.exists(os.path.join(prof, "trace.json"))
    with open(d + "save/logFile.txt") as f:
        assert [ln.split("on iter: ")[1] for ln in f.read().splitlines()] == ["3/6", "6/6"]


@pytest.mark.parametrize(
    "extra, exc, match",
    [
        # ported (A13): DP joins the group on the card and never falls back
        (["--data_parallel", "1", "--device", "cuda"], RuntimeError, "cuda"),
        # ported: mixed precision trains and writes the f32 masters
        (["--compute_dtype", "bfloat16"], None, None),
        (["--compute_dtype", "fp16"], ValueError, "compute_dtype"),
    ],
    ids=["data_parallel", "bfloat16", "unknown_dtype"],
)
def test_trainer_refuses_unported_flags(dataset, tmp_path, extra, exc, match):
    if "cuda" in extra and torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would go ahead")
    if exc is None:
        d = str(tmp_path) + "/"
        ttrain.main(dataset["common"] + ["--checkpoint_path", d, "--max_iters", "2",
                                         "--device", "cpu"] + extra)
        flat, meta = tckpt.load_npz(d + "lstm.npz")
        assert meta["cfg"]["compute_dtype"] == "bfloat16"
        assert all(v.dtype == np.float32 and np.isfinite(v).all() for v in flat.values())
        return
    with pytest.raises(exc, match=match):
        ttrain.main(dataset["common"] + ["--checkpoint_path", str(tmp_path) + "/",
                                         "--device", "cpu"] + extra)


def test_trainer_defaults_to_the_card(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device would run")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(dataset["common"] + ["--checkpoint_path", str(tmp_path) + "/"])
