"""The port's data parallelism (``novel_vqa_torch/parallel``) on gloo at
world size 2: each DP route against one process on the same inputs, the
mirror of tests/test_parallel.py for the JAX mesh.

Two processes come from ``torch.multiprocessing.spawn`` and join one gloo
group on a ``FileStore`` under ``tmp_path`` (so concurrent test workers
never share a port).  One spawn runs every check and records each outcome;
the tests read them.  Each rank draws its dropout masks at the global
batch's shape and keeps its slice (``ops/dropout.py``), so the DP steps
equal one process at dropout 0 and at 0.5 alike.  The ``*_vs_jax`` checks
hold the port's two-rank steps against the JAX package's DP steps on a
two-device CPU mesh, on the same inputs and params: the parent computes
the JAX results before the spawn, the workers never import JAX.  There
dropout is 0 (or the identity on both sides): the two packages' draws
differ in bits.  Tolerances are tests/test_parallel.py's: one step 1e-5
(loss) and 1e-4 / 1e-6 (params), several steps 2e-4 / 2e-5 (losses) and
5e-4 / 1e-5 (params); eval scores 1e-5 / 1e-6.
"""

import datetime
import hashlib
import json
import os
import pickle
import traceback
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from novel_vqa_torch.core.checkpoint import _flatten_tree
from novel_vqa_torch.core.convert import params_from_numpy, params_to_numpy
from novel_vqa_torch.core.tree import tree_leaves
from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.models.seq import autoencoder as ae
from novel_vqa_torch.models.vqa import arch1, arch2
from novel_vqa_torch.parallel import dp as pdp
from novel_vqa_torch.parallel import mesh


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs: the suite runs
    several test processes on one host, and full-width CPU work with a
    thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


WORLD = 2
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
SCAN_TOL = dict(rtol=5e-4, atol=1e-5)
LOSS_SCAN_TOL = dict(rtol=2e-4, atol=2e-5)


def _close(a, b, **tol):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **tol)


A1_DIMS = dict(vocab_size=40, input_encoding_size=8, rnn_size=16, rnn_layer=2, nhimage=16,
               common_embedding_size=12, num_output=5)
A2_DIMS = dict(vocab_size=40, input_encoding_size=10, rnn_size=12, num_layers=1, nhimage=8,
               num_output=4, seq_length=6)
AE_DIMS = dict(vocab_size=30, input_encoding_size=8, rnn_size=12, num_layers=1, seq_length=5)


def _a1_cfg(dropout=0.0):
    return arch1.Arch1Config(**A1_DIMS, dropout=dropout)


def _a2_cfg(dropout=0.0):
    return arch2.Arch2Config(**A2_DIMS, dropout=dropout)


def _close_flat(got, ref, **tol):
    """A port params tree against a flat ``{name: array}`` of the JAX
    package's (``core/checkpoint._flatten_tree`` names)."""
    got = _flatten_tree(got)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)


def _store(rs, n_q, n_im, L, V, F, n_ans, left=False, lengths=None):
    """A resident split store; ``lengths`` per row (default random), right-
    or left-aligned tokens."""
    lengths = rs.randint(1, L + 1, size=n_q) if lengths is None else np.asarray(lengths)
    tokens = np.zeros((n_q, L), np.int64)
    for i, ln in enumerate(lengths):
        toks = rs.randint(1, V + 1, size=ln)
        if left:
            tokens[i, :ln] = toks
        else:
            tokens[i, L - ln:] = toks
    return {
        "tokens": torch.from_numpy(tokens),
        "image": torch.from_numpy(rs.randn(n_im, F).astype(np.float32)),
        "img_pos": torch.from_numpy(rs.randint(1, n_im + 1, size=n_q)),
        "answers": torch.from_numpy(rs.randint(1, n_ans + 1, size=n_q)),
        "mc_ans": torch.from_numpy(rs.randint(0, n_ans + 1, size=(n_q, 18))),
    }


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# --------------------------------------------------------------------------
# checks, each run on every rank of the group
# --------------------------------------------------------------------------

def check_arch1_step(group):
    """make_dp_train_step == one device's step (tests/test_parallel.py:26)."""
    cfg = _a1_cfg()
    tx = arch1.make_optimizer(learning_rate=1e-3)
    params = arch1.init_params(cfg, _gen(0), "cpu")
    rs = np.random.RandomState(0)
    batch = _store(rs, 16, 16, 6, 40, 16, 5)
    tokens, image, labels = batch["tokens"], batch["image"][:16], batch["answers"]
    p1, _, loss1 = arch1.train_step(cfg, tx, params, tx.init(params), tokens, image, labels, _gen(1))
    step = mesh.make_dp_train_step(cfg, tx, group, arch1.loss_fn)
    params2 = group.broadcast_tree(arch1.init_params(cfg, _gen(0), "cpu"))
    p2, _, loss2 = step(params2, tx.init(params2), _gen(1), tokens, image, labels)
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
    _close(p2, p1, **STEP_TOL)


def _arch1_scans(group):
    """12 iterations on one device and on the group, from the same seeds."""
    cfg = _a1_cfg()
    tx = arch1.make_optimizer(learning_rate=1e-3)
    data = _store(np.random.RandomState(1), 96, 24, 6, 40, 16, 5)
    p = arch1.init_params(cfg, _gen(0), "cpu")
    single = arch1.train_steps_scan(cfg, tx, p, tx.init(p), data, 12, 16, _gen(7))
    scan = pdp.make_vqa_dp_steps_scan(arch1.loss_fn, cfg, tx, group, 12, 16)
    p = arch1.init_params(cfg, _gen(0), "cpu")
    return single, scan(p, tx.init(p), data, _gen(7))


def check_arch1_scan(group):
    """12 iterations of on-device sampling, each rank its slice of the
    global indices (tests/test_parallel.py:82)."""
    (p1, _, l1), (p2, _, l2) = _arch1_scans(group)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), **LOSS_SCAN_TOL)
    _close(p2, p1, **SCAN_TOL)


def _digest(tree) -> str:
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def check_ranks_stay_in_step(group):
    """After 12 DP iterations every rank's params and optimizer state are
    bit-identical (an all-gather of a digest)."""
    _, (p2, o2, l2) = _arch1_scans(group)
    digests = [None] * group.world_size
    dist.all_gather_object(digests, (_digest(p2), _digest(o2), _digest(l2)))
    assert len(set(digests)) == 1, digests


def _arch2_skip_batch():
    """16 left-aligned questions: rows 0-7 (rank 0's shard) of 1-2 tokens,
    rows 8-15 of 5-6, so the shards' last active steps differ."""
    rs = np.random.RandomState(2)
    lengths = np.concatenate([rs.randint(1, 3, size=8), rs.randint(5, 7, size=8)])
    return _store(rs, 16, 16, 6, 40, 8, 4, left=True, lengths=lengths)


def check_arch2_can_skip(group):
    """arch2's DP step and eval on a batch whose shards differ in can_skip:
    the encoder's any() spans the global batch, so both equal one device;
    without the all-reduce rank 0's scores would differ."""
    cfg = _a2_cfg()
    tx = arch2.make_optimizer(learning_rate=1e-3)
    data = _arch2_skip_batch()
    qinds = torch.arange(16)
    params = arch2.init_params(cfg, _gen(0), "cpu")
    p1, _, loss1 = arch2.train_step_indexed(cfg, tx, params, tx.init(params), data, qinds, _gen(3))
    step = pdp.make_vqa_dp_indexed_step(arch2.loss_fn, cfg, tx, group)
    p0 = arch2.init_params(cfg, _gen(0), "cpu")
    p2, _, loss2 = step(p0, tx.init(p0), data, qinds, _gen(3))
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
    _close(p2, p1, **STEP_TOL)
    # the eval forward over the same batch
    _, ref = arch2.eval_step_indexed(cfg, params, data, qinds)
    fwd = mesh.make_dp_eval_indexed_step(cfg, group, arch2.eval_step_indexed)
    _, got = fwd(params, data, qinds)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    # the batch tells the two apart: a local any() changes rank 0's rows
    _, local = arch2.eval_step_indexed(cfg, params, data, group.shard(qinds))
    if group.rank == 0:
        assert not torch.allclose(local, group.shard(ref), rtol=1e-5, atol=1e-6)


def check_arch2_scan(group):
    """arch2's DP multi-step loop, 8 iterations (tests/test_parallel.py:137)."""
    cfg = _a2_cfg()
    tx = arch2.make_optimizer(learning_rate=1e-3)
    data = _store(np.random.RandomState(2), 64, 16, 6, 40, 8, 4, left=True)
    p = arch2.init_params(cfg, _gen(0), "cpu")
    p1, _, l1 = arch2.train_steps_scan(cfg, tx, p, tx.init(p), data, 8, 16, _gen(9))
    scan = pdp.make_vqa_dp_steps_scan(arch2.loss_fn, cfg, tx, group, 8, 16)
    p = arch2.init_params(cfg, _gen(0), "cpu")
    p2, _, l2 = scan(p, tx.init(p), data, _gen(9))
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), **LOSS_SCAN_TOL)
    _close(p2, p1, **SCAN_TOL)


def _identity_dropout(x, rate, generator, deterministic, **kw):
    return x


def _ae_setup(variant, dropout=0.0):
    from novel_vqa_torch.ops import optim

    cfg = ae.AEConfig(**AE_DIMS, dropout=dropout, variant=variant)
    tx = optim.chain(optim.clamp(0.1), optim.adam(1e-3, 0.8, 0.999, 1e-8))
    return cfg, tx


def _unequal_tokens_batch(cfg):
    """8 time-major rows: rank 0's shard holds 4-5 tokens a row, rank 1's
    one, so the shards differ in token count and in can_skip."""
    rs = np.random.RandomState(5)
    lengths = np.array([5, 4, 5, 4, 1, 1, 1, 1])
    seq = np.zeros((5, 8), np.int64)
    for i, ln in enumerate(lengths):
        seq[:ln, i] = rs.randint(1, 31, size=ln)
    return torch.from_numpy(seq), torch.zeros(8, cfg.input_encoding_size)


def check_text_ae_unequal_tokens(group):
    """The text AE's DP step on a batch whose shards hold unequal token
    counts (rank 0: 4-5 tokens a row, rank 1: 1) and differ in can_skip:
    the NLL divides by the global count, so the summed gradients are one
    device's.  The mean of the ranks' own ratios would not be."""
    from novel_vqa_torch.train import train_text_ae as tt

    with mock.patch.object(ae, "dropout", _identity_dropout):
        for variant in ("text_nostart", "arch2"):
            cfg, tx = _ae_setup(variant)
            seq, imgs = _unequal_tokens_batch(cfg)
            params = ae.init_params(cfg, _gen(3), "cpu")
            opt = tx.init(params)
            step = tt.make_dp_step(cfg, tx, group)
            p2 = group.broadcast_tree(ae.init_params(cfg, _gen(3), "cpu"))
            o2 = tx.init(p2)
            for _ in range(3):
                params, opt, loss1 = tt.train_step(cfg, tx, params, opt, seq, _gen(1), imgs)
                p2, o2, loss2 = step(p2, o2, _gen(1), seq, imgs)
                np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
            _close(p2, params, **SCAN_TOL)
            # the batch tells the reductions apart
            kw = {"imgs": imgs[:4]} if variant == "arch2" else {}
            local = ae.apply_nll(params, cfg, group.shard(seq, 1), deterministic=True, **kw)[0]
            mean_of_ratios = float(group.reduce_tree(local, "mean"))
            full = float(ae.apply_nll(params, cfg, seq, deterministic=True,
                                      **({"imgs": imgs} if variant == "arch2" else {}))[0])
            assert abs(mean_of_ratios - full) > 1e-3 * abs(full)


def check_text_ae_scan(group):
    """The text AE's DP multi-step loop over the resident corpus, 10
    iterations with wrap (tests/test_parallel.py:244, :295)."""
    from novel_vqa_torch.train import train_text_ae as tt

    with mock.patch.object(ae, "dropout", _identity_dropout):
        for variant, n_rows, bs, n_steps in (("text_nostart", 37, 16, 10), ("arch2", 29, 8, 6)):
            cfg, tx = _ae_setup(variant)
            rs = np.random.RandomState(5)
            rows = np.zeros((n_rows, 5), np.int64)
            for i, ln in enumerate(rs.randint(1, 6, size=n_rows)):
                rows[i, :ln] = rs.randint(1, 31, size=ln)
            rows = torch.from_numpy(rows)
            p = ae.init_params(cfg, _gen(3), "cpu")
            p1, _, off1, l1 = tt.train_steps_scan(cfg, tx, p, tx.init(p), rows,
                                                  torch.tensor(0), n_steps, bs, _gen(11))
            p = ae.init_params(cfg, _gen(3), "cpu")
            p2, _, off2, l2 = tt.train_steps_scan(cfg, tx, p, tx.init(p), rows,
                                                  torch.tensor(0), n_steps, bs, _gen(11),
                                                  dp=group)
            assert int(off1) == int(off2)
            np.testing.assert_allclose(l2.numpy(), l1.numpy(), **LOSS_SCAN_TOL)
            _close(p2, p1, **SCAN_TOL)


def _weakpaired_check(group, drop):
    from novel_vqa_torch.train import train_weakpaired_ae as wp

    opt = wp.WPTrainConfig(batch_size=8, crop_size=32, image_size=40, variant="null",
                           rnn_size=8, input_encoding_size=8, learning_rate=1e-3,
                           cnn_learning_rate=1e-3, drop_prob_ae=drop, device="cpu")
    cfg = ae.AEConfig(vocab_size=20, input_encoding_size=8, rnn_size=8, num_layers=1,
                      seq_length=4, dropout=drop, variant="null")
    rs = np.random.RandomState(9)
    N, L = 8, 4
    images = torch.from_numpy(rs.randint(0, 256, size=(N, 40, 40, 3)).astype(np.uint8))
    offsets = torch.from_numpy(rs.randint(0, 9, size=(N, 2)).astype(np.int32))
    lengths = np.array([4, 4, 3, 4, 1, 2, 1, 1])  # unequal counts, can_skip differs
    labels = np.zeros((L, N), np.int64)
    for i, ln in enumerate(lengths):
        labels[:ln, i] = rs.randint(1, 21, size=ln)
    labels = torch.from_numpy(labels)
    sent = torch.zeros(N, 2 * cfg.rnn_size)
    phases = [(False, labels), (False, torch.zeros_like(labels)), (True, labels)]

    def run(dp):
        cnn, cnn_apply, _ = wp.build_cnn(opt, True, _gen(7), "cpu")
        aep = ae.init_params(cfg, _gen(8), "cpu")
        ae_tx, cnn_tx = wp.make_ae_tx(opt), wp.make_cnn_tx(opt)
        aeo, cnno = ae_tx.init(aep), cnn_tx.init(cnn)
        step = wp.make_train_step(cfg, "null", 32, cnn_apply, ae_tx, cnn_tx, dp=dp)
        losses = []
        for i, (finetune, seq_input) in enumerate(phases):
            aep, aeo, cnn, cnno, loss = step(False, finetune, aep, aeo, cnn, cnno, images,
                                             offsets, labels, sent, seq_input, _gen(20 + i))
            losses.append(float(loss))
        return aep, cnn, losses

    ae1, cnn1, l1 = run(None)
    ae2, cnn2, l2 = run(group)
    np.testing.assert_allclose(l2, l1, rtol=1e-4)
    _close(ae2, ae1, **SCAN_TOL)
    _close(cnn2, cnn1, **SCAN_TOL)


def check_weakpaired_step(group):
    """The weak-paired joint step (null variant, VGG-16 at crop 32) through
    both finetune phases and a zeroed encoder input: both nets' summed
    gradients are one device's (tests/test_parallel.py:340)."""
    _weakpaired_check(group, 0.0)


def check_weakpaired_dropout(group):
    """The same three phases at dropout 0.5 (the AE's own and the
    embedding's fixed 0.5): the masks are the global batch's, so the DP
    step is still one process's."""
    _weakpaired_check(group, 0.5)


def check_eval_forward(group):
    """make_dp_eval_step and make_dp_eval_indexed_step return one device's
    scores in value and global row order (tests/test_parallel.py:426, :553)."""
    cfg = _a1_cfg()
    params = arch1.init_params(cfg, _gen(0), "cpu")
    data = _store(np.random.RandomState(3), 40, 11, 6, 40, 16, 5)
    qinds = torch.from_numpy(np.random.RandomState(4).randint(0, 40, size=24))
    tokens, image, labels = pdp.gather_batch(data, qinds)
    loss1, s1 = arch1.eval_step(cfg, params, tokens, image, labels)
    step = mesh.make_dp_eval_step(cfg, group, arch1.eval_step)
    loss2, s2 = step(params, tokens, image, labels)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
    fwd = mesh.make_dp_eval_indexed_step(cfg, group, arch1.eval_predict_indexed)
    _, pred2, mc2 = fwd(params, data, qinds)
    _, pred1, mc1 = arch1.eval_predict_indexed(cfg, params, data, qinds)
    assert torch.equal(pred2, pred1) and torch.equal(mc2, mc1)


class _Split:
    """The slice of ``data/vqa.VQAData`` that ``run_full_split`` reads."""

    def __init__(self, store, n):
        self.store, self.n = store, n

    def num_examples(self, split):
        return self.n

    def split_store(self, split):
        return {k: v.numpy() for k, v in self.store.items()}

    def iter_split(self, split, batch_size):
        from types import SimpleNamespace

        for s in range(0, self.n, batch_size):
            q = np.arange(s, min(self.n, s + batch_size))
            tokens, image, labels = pdp.gather_batch(self.store, torch.from_numpy(q))
            yield SimpleNamespace(question_id=q, tokens=tokens.numpy(), image=image.numpy(),
                                  labels=labels.numpy())


def check_run_full_split(group):
    """The eval loop's DP routes (resident and streaming) against one
    device for arch1 and for arch2 (a final short batch, shards that
    differ in can_skip): predictions equal, scores within 1e-5."""
    from novel_vqa_torch.train.eval_loop import run_full_split

    for arch, cfg, left in ((arch1, _a1_cfg(), False), (arch2, _a2_cfg(), True)):
        data = _store(np.random.RandomState(6), 21, 7, 6, 40, cfg.nhimage, 4, left=left)
        split = _Split(data, 21)
        params = arch.init_params(cfg, _gen(0), "cpu")
        kw = dict(device="cpu")
        pred1, mc1, _ = run_full_split(arch, cfg, params, split, "test", 8, **kw)
        pred2, mc2, _ = run_full_split(arch, cfg, params, split, "test", 8, group=group, **kw)
        np.testing.assert_array_equal(pred2, pred1)
        np.testing.assert_array_equal(mc2, mc1)
        for hbm in (True, False):
            _, _, s1 = run_full_split(arch, cfg, params, split, "test", 8, hbm_resident=hbm,
                                      want="scores", **kw)
            _, _, s2 = run_full_split(arch, cfg, params, split, "test", 8, hbm_resident=hbm,
                                      want="scores", group=group, **kw)
            assert s2.shape == (21, cfg.num_output)
            np.testing.assert_allclose(s2, s1, rtol=1e-5, atol=1e-6)


def check_shards_and_replicas(group):
    """``DPGroup.shard`` gives this rank's contiguous rows (or columns),
    ``broadcast_tree`` rank 0's values."""
    a = torch.arange(24).reshape(4, 6)
    r = group.rank
    np.testing.assert_array_equal(group.shard(a).numpy(), a[2 * r: 2 * r + 2].numpy())
    np.testing.assert_array_equal(group.shard(a, 1).numpy(), a[:, 3 * r: 3 * r + 3].numpy())
    tree = group.broadcast_tree({"w": torch.full((3,), float(r)), "l": [torch.tensor(r + 1.0)]})
    assert tree["w"].tolist() == [0.0] * 3 and float(tree["l"][0]) == 1.0


def check_sharded_extraction(group):
    """``extract_features`` under a world of 2 (``WORLD_SIZE``, as torchrun
    sets it) shards each image batch, gathers the features in row order
    and only rank 0 writes: the store equals a run in one process."""
    from PIL import Image

    from novel_vqa_torch.core.h5 import H5Reader
    from novel_vqa_torch.train import extract_features

    root = os.path.join(_OUT_DIR, "extract")
    if group.rank == 0:
        os.makedirs(root)
        rs = np.random.RandomState(0)
        for i in range(6):
            Image.fromarray(rs.randint(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                os.path.join(root, f"im{i}.png"))
        with open(os.path.join(root, "meta.json"), "w") as f:
            json.dump({"unique_img_train": [f"im{i}.png" for i in range(6)]}, f)
    group.barrier()
    argv = ["--input_json", os.path.join(root, "meta.json"), "--image_root", root,
            "--image_size", "32", "--batch_size", "4", "--decode_workers", "1", "--device", "cpu"]
    with mock.patch.dict(os.environ, {"WORLD_SIZE": "2"}):
        extract_features.main(argv + ["--out_name", os.path.join(root, f"dp{group.rank}.h5")])
    group.barrier()
    assert not os.path.exists(os.path.join(root, "dp1.h5"))
    if group.rank == 0:
        with mock.patch.dict(os.environ, {}, clear=False):
            os.environ.pop("WORLD_SIZE", None)
            with mock.patch.object(dist, "is_initialized", lambda: False):
                extract_features.main(argv + ["--out_name", os.path.join(root, "one.h5")])
        with H5Reader(os.path.join(root, "dp0.h5")) as a, H5Reader(os.path.join(root, "one.h5")) as b:
            assert a["images_train"].shape == (6, 4096)
            np.testing.assert_allclose(a["images_train"], b["images_train"], rtol=1e-5, atol=1e-6)
    group.barrier()


def check_indivisible_batch_raises(group):
    cfg = _a1_cfg()
    z = torch.zeros(3, 6, dtype=torch.long)
    for build in (lambda: mesh.make_dp_eval_step(cfg, group, arch1.eval_step)(None, z, z, z),
                  lambda: mesh.make_dp_eval_indexed_step(cfg, group, arch1.eval_step_indexed)(
                      None, None, torch.arange(3)),
                  lambda: pdp.make_vqa_dp_steps_scan(arch1.loss_fn, cfg, None, group, 2, 5),
                  lambda: mesh.cli_group(1, "cpu", 7)):
        with pytest.raises(ValueError, match="not divisible"):
            build()


# --------------------------------------------------------------------------
# dropout on: every mask is the global batch's, so DP is one process
# --------------------------------------------------------------------------

def check_dropout_mask_is_the_global_masks_slice(group):
    """A rank's mask is its slice, along the batch axis, of the mask one
    process draws for the global batch from the same seed; so the two
    ranks' masks differ."""
    r = group.rank
    for axis, shape in ((0, (4, 6)), (1, (3, 4, 5))):
        n = shape[axis]
        whole = list(shape)
        whole[axis] *= group.world_size
        got = dropout(torch.ones(shape), 0.5, _gen(5), False, dp=group, axis=axis)
        ref = dropout(torch.ones(whole), 0.5, _gen(5), False).narrow(axis, r * n, n)
        assert torch.equal(got, ref)
        both = group.gather(got.movedim(axis, 0).contiguous())
        assert not torch.equal(both[:n], both[n:])


def check_arch1_dropout(group):
    """arch1 at dropout 0.5: one DP step and 6 iterations of the DP loop
    equal one process drawing from the same seeds."""
    cfg = _a1_cfg(dropout=0.5)
    tx = arch1.make_optimizer(learning_rate=1e-3)
    batch = _store(np.random.RandomState(0), 16, 16, 6, 40, 16, 5)
    args = (batch["tokens"], batch["image"], batch["answers"])
    p = arch1.init_params(cfg, _gen(0), "cpu")
    p1, _, loss1 = arch1.train_step(cfg, tx, p, tx.init(p), *args, _gen(1))
    p = arch1.init_params(cfg, _gen(0), "cpu")
    p2, _, loss2 = mesh.make_dp_train_step(cfg, tx, group, arch1.loss_fn)(
        p, tx.init(p), _gen(1), *args)
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
    _close(p2, p1, **STEP_TOL)
    data = _store(np.random.RandomState(1), 96, 24, 6, 40, 16, 5)
    p = arch1.init_params(cfg, _gen(0), "cpu")
    p1, _, l1 = arch1.train_steps_scan(cfg, tx, p, tx.init(p), data, 6, 16, _gen(7))
    p = arch1.init_params(cfg, _gen(0), "cpu")
    scan = pdp.make_vqa_dp_steps_scan(arch1.loss_fn, cfg, tx, group, 6, 16)
    p2, _, l2 = scan(p, tx.init(p), data, _gen(7))
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), **LOSS_SCAN_TOL)
    _close(p2, p1, **SCAN_TOL)


def check_arch2_dropout(group):
    """arch2 at dropout 0.5 on the can_skip batch: the DP step equals one
    process."""
    cfg = _a2_cfg(dropout=0.5)
    tx = arch2.make_optimizer(learning_rate=1e-3)
    data, qinds = _arch2_skip_batch(), torch.arange(16)
    p = arch2.init_params(cfg, _gen(0), "cpu")
    p1, _, loss1 = arch2.train_step_indexed(cfg, tx, p, tx.init(p), data, qinds, _gen(3))
    p = arch2.init_params(cfg, _gen(0), "cpu")
    step = pdp.make_vqa_dp_indexed_step(arch2.loss_fn, cfg, tx, group)
    p2, _, loss2 = step(p, tx.init(p), data, qinds, _gen(3))
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
    _close(p2, p1, **STEP_TOL)


def check_text_ae_dropout(group):
    """The text AEs at dropout 0.5 (and the embedding's fixed 0.5) on the
    unequal-tokens batch: 3 DP steps and a 4-iteration DP loop equal one
    process."""
    from novel_vqa_torch.train import train_text_ae as tt

    for variant in ("text_nostart", "arch2"):
        cfg, tx = _ae_setup(variant, dropout=0.5)
        seq, imgs = _unequal_tokens_batch(cfg)
        p1 = ae.init_params(cfg, _gen(3), "cpu")
        p2 = ae.init_params(cfg, _gen(3), "cpu")
        o1, o2 = tx.init(p1), tx.init(p2)
        step = tt.make_dp_step(cfg, tx, group)
        for i in range(3):
            p1, o1, loss1 = tt.train_step(cfg, tx, p1, o1, seq, _gen(10 + i), imgs)
            p2, o2, loss2 = step(p2, o2, _gen(10 + i), seq, imgs)
            np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
        _close(p2, p1, **SCAN_TOL)
        rows = seq.t().contiguous()
        runs = []
        for dp in (None, group):
            p = ae.init_params(cfg, _gen(3), "cpu")
            runs.append(tt.train_steps_scan(cfg, tx, p, tx.init(p), rows, torch.tensor(0), 4, 8,
                                            _gen(11), dp=dp))
        np.testing.assert_allclose(runs[1][3].numpy(), runs[0][3].numpy(), **LOSS_SCAN_TOL)
        _close(runs[1][0], runs[0][0], **SCAN_TOL)


# --------------------------------------------------------------------------
# against the JAX package's DP steps (references computed by the parent)
# --------------------------------------------------------------------------

def check_arch2_can_skip_vs_jax(group):
    """arch2's two-rank DP step and eval forward on the batch whose shards
    differ in can_skip, against JAX's ``make_vqa_dp_indexed_step`` and
    ``make_dp_eval_indexed_step`` over a two-device mesh."""
    ref = _JAX["arch2"]
    cfg = _a2_cfg()
    tx = arch2.make_optimizer(learning_rate=1e-3)
    data, qinds = _arch2_skip_batch(), torch.arange(16)
    p = params_from_numpy(ref["params0"], "cpu")
    step = pdp.make_vqa_dp_indexed_step(arch2.loss_fn, cfg, tx, group)
    p2, _, loss2 = step(p, tx.init(p), data, qinds, _gen(3))
    np.testing.assert_allclose(float(loss2), ref["loss"], rtol=1e-5)
    _close_flat(p2, ref["params1"], **STEP_TOL)
    fwd = mesh.make_dp_eval_indexed_step(cfg, group, arch2.eval_step_indexed)
    _, scores = fwd(params_from_numpy(ref["params0"], "cpu"), data, qinds)
    np.testing.assert_allclose(scores.numpy(), ref["scores"], rtol=1e-5, atol=1e-6)


def check_text_ae_unequal_tokens_vs_jax(group):
    """The text AEs' two-rank DP step, 3 steps on the unequal-tokens batch,
    against JAX's ``make_dp_train_step`` with the batch sharded on axis 1
    (dropouts the identity on both sides)."""
    from novel_vqa_torch.train import train_text_ae as tt

    with mock.patch.object(ae, "dropout", _identity_dropout):
        for variant in ("text_nostart", "arch2"):
            ref = _JAX["ae_" + variant]
            cfg, tx = _ae_setup(variant)
            seq, imgs = _unequal_tokens_batch(cfg)
            p = params_from_numpy(ref["params0"], "cpu")
            o = tx.init(p)
            step = tt.make_dp_step(cfg, tx, group)
            losses = []
            for _ in range(3):
                p, o, loss = step(p, o, _gen(1), seq, imgs)
                losses.append(float(loss))
            np.testing.assert_allclose(losses, ref["losses"], **LOSS_SCAN_TOL)
            _close_flat(p, ref["params1"], **SCAN_TOL)


def check_eval_forward_vs_jax(group):
    """The two-rank eval forwards (streamed and resident) against JAX's
    ``make_dp_eval_step`` and ``make_dp_eval_indexed_step``: scores,
    loss, and the OE/MC predictions in global row order."""
    ref = _JAX["eval"]
    cfg = _a1_cfg()
    params = params_from_numpy(ref["params0"], "cpu")
    data, qinds = _eval_batch()
    loss, scores = mesh.make_dp_eval_step(cfg, group, arch1.eval_step)(
        params, *pdp.gather_batch(data, qinds))
    np.testing.assert_allclose(scores.numpy(), ref["scores"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    fwd = mesh.make_dp_eval_indexed_step(cfg, group, arch1.eval_predict_indexed)
    _, pred, mc = fwd(params, data, qinds)
    np.testing.assert_array_equal(pred.numpy(), ref["pred"])
    np.testing.assert_array_equal(mc.numpy(), ref["mc"])


def _eval_batch():
    data = _store(np.random.RandomState(3), 40, 11, 6, 40, 16, 5)
    return data, torch.from_numpy(np.random.RandomState(4).randint(0, 40, size=24))


def _jax_references(path):
    """The JAX package's DP results on a two-device CPU mesh for the
    ``*_vs_jax`` checks, pickled to ``path`` (numpy only).  Both packages
    start from the port's seeded params (JAX's eager init compiles an op
    per leaf, seconds per model)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from novel_vqa_tpu.models.seq import autoencoder as jae
    from novel_vqa_tpu.models.vqa import arch1 as jarch1
    from novel_vqa_tpu.models.vqa import arch2 as jarch2
    from novel_vqa_tpu.ops import fusion as jfusion
    from novel_vqa_tpu.ops import optim as jopt
    from novel_vqa_tpu.parallel import dp as jdp
    from novel_vqa_tpu.parallel import mesh as jmesh_mod

    jmesh = jmesh_mod.make_mesh(WORLD)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731

    def host(t):
        a = t.numpy()
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)

    out = {}
    cfg = jarch2.Arch2Config(**A2_DIMS, dropout=0.0)
    params = params_to_numpy(arch2.init_params(_a2_cfg(), _gen(0), "cpu"))
    tx = jarch2.make_optimizer(learning_rate=1e-3)
    data = {k: host(v) for k, v in _arch2_skip_batch().items()}
    qinds = jnp.arange(16, dtype=jnp.int32)
    step = jdp.make_vqa_dp_indexed_step(jarch2.loss_fn, cfg, tx, jmesh)
    p1, _, loss = step(jax.tree_util.tree_map(jnp.asarray, params), tx.init(params), data, qinds,
                       jax.random.PRNGKey(0))
    _, scores = jmesh_mod.make_dp_eval_indexed_step(cfg, jmesh, jarch2.eval_step_indexed)(
        params, data, qinds)
    out["arch2"] = dict(params0=params, params1=_flatten_tree(np_tree(p1)), loss=float(loss),
                        scores=np.asarray(scores))

    identity = lambda rng, x, rate, deterministic: x  # noqa: E731
    with mock.patch.object(jae, "dropout", identity), mock.patch.object(jfusion, "dropout", identity):
        for variant in ("text_nostart", "arch2"):
            cfg = jae.AEConfig(**AE_DIMS, dropout=0.0, variant=variant)
            params = params_to_numpy(ae.init_params(_ae_setup(variant)[0], _gen(3), "cpu"))
            tx = optax.chain(jopt.clamp(0.1), jopt.adam(1e-3, 0.8, 0.999, 1e-8))

            def loss_fn(p, cfg, seq, imgs, rng, variant=variant):
                return jae.loss_fn(p, cfg, seq, rng, **({"imgs": imgs} if variant == "arch2" else {}))

            step = jmesh_mod.make_dp_train_step(cfg, tx, jmesh, loss_fn, donate=False,
                                                batch_specs=(P(None, "data"), P("data")))
            seq, imgs = _unequal_tokens_batch(cfg)
            p, o, losses = jax.tree_util.tree_map(jnp.asarray, params), tx.init(params), []
            for _ in range(3):
                p, o, loss = step(p, o, jax.random.PRNGKey(1), host(seq), host(imgs))
                losses.append(float(loss))
            out["ae_" + variant] = dict(params0=params, params1=_flatten_tree(np_tree(p)),
                                        losses=losses)

    cfg = jarch1.Arch1Config(**A1_DIMS, dropout=0.0)
    params = params_to_numpy(arch1.init_params(_a1_cfg(), _gen(0), "cpu"))
    data, qinds = _eval_batch()
    batch = jmesh_mod.shard_batch_arrays(
        jmesh, *(host(t) for t in pdp.gather_batch(data, qinds)))
    loss, scores = jmesh_mod.make_dp_eval_step(cfg, jmesh, jarch1.eval_step)(params, *batch)
    _, pred, mc = jmesh_mod.make_dp_eval_indexed_step(cfg, jmesh, jarch1.eval_predict_indexed)(
        params, {k: host(v) for k, v in data.items()}, host(qinds))
    out["eval"] = dict(params0=params, loss=float(loss), scores=np.asarray(scores),
                       pred=np.asarray(pred), mc=np.asarray(mc))
    with open(path, "wb") as f:
        pickle.dump(out, f)


CHECKS = [name for name in dir() if name.startswith("check_")]


_OUT_DIR = ""  # the spawn's shared directory, set in each worker
_JAX: dict = {}  # the JAX package's results for the *_vs_jax checks, loaded in each worker


def _worker(rank, store_path, out_dir):
    global _OUT_DIR, _JAX
    _OUT_DIR = out_dir
    with open(os.path.join(out_dir, "jax.pkl"), "rb") as f:
        _JAX = pickle.load(f)
    torch.set_num_threads(2)
    # a check that fails on one rank must not leave the other waiting
    dist.init_process_group("gloo", init_method=f"file://{store_path}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        group = mesh.make_mesh("cpu")
        results = {}
        for name in CHECKS:
            try:
                globals()[name](group)
                results[name] = "ok"
            except Exception:  # recorded per check; the test of that check fails
                results[name] = traceback.format_exc()
            dist.barrier()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    _jax_references(str(tmp / "jax.pkl"))
    mp.spawn(_worker, args=(str(tmp / "store"), str(tmp)), nprocs=WORLD, join=True)
    out = {}
    for rank in range(WORLD):
        with open(tmp / f"rank{rank}.json") as f:
            for name, res in json.load(f).items():
                out.setdefault(name, {})[rank] = res
    return out


@pytest.mark.parametrize("check", CHECKS)
def test_dp_route_equals_one_process(outcomes, check):
    for rank, res in outcomes[check].items():
        assert res == "ok", f"rank {rank}:\n{res}"


# --------------------------------------------------------------------------
# in one process
# --------------------------------------------------------------------------

def test_one_process_group_is_the_identity(monkeypatch):
    """Without torchrun and without a group: world size 1, every collective
    the identity, the shard the whole batch."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    group = mesh.make_mesh("cpu")
    assert (group.rank, group.world_size, group.backend) == (0, 1, None)
    x = torch.arange(6.0)
    assert torch.equal(group.shard(x), x) and torch.equal(group.gather(x), x)
    assert torch.equal(group.sum(x), x)
    tree = {"a": x, "b": [x * 2]}
    assert group.reduce_tree(tree) is tree


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_mesh()  # the default device is the card
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.cli_group(1, "cuda", 8)


def test_deferred_fetch_order_and_depth():
    """DeferredFetch returns results in put order with metas intact, at most
    ``depth`` pending (tests/test_parallel.py:501)."""
    fetch = pdp.DeferredFetch(depth=2)
    for i in range(5):
        fetch.put(torch.full((3,), float(i)), ("meta", i))
        assert len(fetch._q) <= 2
    out = fetch.results()
    assert [m for _, m in out] == [("meta", i) for i in range(5)]
    for i, (s, _) in enumerate(out):
        assert isinstance(s, np.ndarray)
        np.testing.assert_array_equal(s, np.full((3,), i, np.float32))
    assert fetch.results() is out


def test_fetch_chunked_identity():
    """fetch_chunked returns the one-shot copy's bytes, ragged final chunks
    and tiny inputs included (tests/test_parallel.py:653)."""
    rs = np.random.RandomState(7)
    for shape, rows in [((23, 5, 7), 4), ((8, 3), 3), ((5,), 100), ((1, 4), 1)]:
        host = rs.randn(*shape).astype(np.float32)
        np.testing.assert_array_equal(pdp.fetch_chunked(torch.from_numpy(host), rows), host)
    host = rs.randn(16, 8).astype(np.float32)
    np.testing.assert_array_equal(pdp.fetch_chunked(torch.from_numpy(host)), host)
