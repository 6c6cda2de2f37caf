"""``--data_parallel 1`` through the port's arch1 CLIs (the mirror of
tests/test_dp_trainer.py): ``train_vqa_arch1`` (both dispatch modes) and
``eval_vqa_arch1`` (both store modes) in two gloo processes at the CLI's
dropout (0.5: each rank's masks are its slice of the global batch's)
against one process; only rank 0 writes; and in one process without a
group, where the DP route is the plain route bit for bit."""

import datetime
import json
import os

import h5py
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from novel_vqa_torch.core.checkpoint import load_flat_h5
from novel_vqa_torch.train import eval_vqa_arch1 as teval
from novel_vqa_torch.train import train_vqa_arch1 as ttrain


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs: the suite runs
    several test processes on one host, and full-width CPU work with a
    thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


V, L, N_ANS, F = 20, 5, 4, 8
WIDTHS = ["--nhimage", str(F), "--input_encoding_size", "8", "--rnn_size", "12",
          "--rnn_layer", "2", "--common_embedding_size", "8", "--num_output", str(N_ANS)]
RESULTS = ("OpenEnded_mscoco_val2014_lstm_novel_new_2_results.json",
           "MultipleChoice_mscoco_val2014_lstm_novel_new_2_results.json")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_cli")
    rs = np.random.RandomState(0)
    n_img = 8
    img_ans = rs.randint(1, N_ANS + 1, size=n_img)
    feats = (np.eye(N_ANS)[img_ans - 1] @ rs.randn(N_ANS, F)).astype(np.float32)

    def mk(n):
        img_pos = rs.randint(1, n_img + 1, size=n).astype(np.uint32)
        lens = rs.randint(1, L + 1, size=n).astype(np.uint32)
        q = np.zeros((n, L), np.uint32)
        for i, ln in enumerate(lens):
            q[i, :ln] = rs.randint(1, V + 1, size=ln)
        return q, lens, np.arange(1, n + 1, dtype=np.uint32), img_pos, img_ans[img_pos - 1]

    splits = {"train": mk(120), "val": mk(24), "test": mk(50)}
    ques_h5, img_h5, meta = str(tmp / "q.h5"), str(tmp / "i.h5"), str(tmp / "m.json")
    with h5py.File(ques_h5, "w") as f:
        for name, s in splits.items():
            for key, arr in zip(("ques", "ques_length", "question_id", "img_pos"), s[:4]):
                f.create_dataset(f"{key}_{name}", dtype="uint32", data=arr)
        f.create_dataset("answers", dtype="uint32", data=splits["train"][4].astype(np.uint32))
        f.create_dataset("answers_val", dtype="uint32", data=splits["val"][4].astype(np.uint32))
        mc = np.zeros((50, 18), np.uint32)
        mc[:, :3] = rs.randint(1, N_ANS + 1, size=(50, 3))
        f.create_dataset("MC_ans_test", dtype="uint32", data=mc)
    with h5py.File(img_h5, "w") as f:
        for name in splits:
            f.create_dataset(f"images_{name}", dtype="float32", data=feats)
    with open(meta, "w") as f:
        json.dump({"ix_to_word": {str(i): f"w{i}" for i in range(1, V + 1)},
                   "ix_to_ans": {str(i): f"a{i}" for i in range(1, N_ANS + 1)}}, f)
    common = ["--input_img_h5", img_h5, "--input_ques_h5", ques_h5, "--input_json", meta,
              "--batch_size", "16", "--device", "cpu"] + WIDTHS
    return tmp, common


def _train_argv(common, out, spd):
    return common + ["--checkpoint_path", out, "--max_iters", "8", "--save_checkpoint_every", "8",
                     "--log_every", "4", "--steps_per_dispatch", str(spd)]


def _eval_argv(common, model, out, hbm):
    return common + ["--model_path", model, "--out_path", out, "--hbm_resident", str(hbm)]


def _runs(common, root, rank, dp):
    """The four CLI runs of one process; rank r writes under ``root/r<r>``."""
    base = os.path.join(root, f"r{rank}")
    flag = ["--data_parallel", "1"] if dp else []
    for spd in (1, 4):
        ttrain.main(_train_argv(common, f"{base}/spd{spd}/", spd) + flag)
    model = os.path.join(root, "r0", "spd1", "lstm.h5")
    if dp:
        dist.barrier()  # rank 0's checkpoint is written
    for hbm in (1, 0):
        teval.main(_eval_argv(common, model, f"{base}/eval{hbm}/", hbm) + flag)


def _worker(rank, store, common, root):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        _runs(common, root, rank, dp=True)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(data):
    tmp, common = data
    single, dp = str(tmp / "single"), str(tmp / "dp")
    _runs(common, single, 0, dp=False)
    mp.spawn(_worker, args=(str(tmp / "store"), common, dp), nprocs=2, join=True)
    return single, dp


@pytest.mark.parametrize("spd", [1, 4])
def test_dp_trainer_matches_one_process(runs, spd):
    single, dp = runs
    a = load_flat_h5(f"{single}/r0/spd{spd}/lstm.h5")
    b = load_flat_h5(f"{dp}/r0/spd{spd}/lstm.h5")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=5e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("hbm", [1, 0])
def test_dp_eval_matches_one_process(runs, hbm):
    single, dp = runs
    for name in RESULTS:
        with open(f"{single}/r0/eval{hbm}/{name}") as f1, open(f"{dp}/r0/eval{hbm}/{name}") as f2:
            assert f1.read() == f2.read(), name


def test_only_rank_0_writes(runs):
    _, dp = runs
    assert os.path.exists(f"{dp}/r0/spd1/lstm.h5") and os.path.exists(f"{dp}/r0/eval1/{RESULTS[0]}")
    assert not os.path.exists(f"{dp}/r1")


def test_dp_in_one_process_is_the_plain_run(data, tmp_path, monkeypatch):
    """Without torchrun and without a group the DP route runs at world size
    1: the checkpoint and the result JSONs are the plain run's byte for
    byte (dropout on: the same masks are drawn)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    _, common = data
    out = {}
    for name, flag in (("plain", []), ("dp", ["--data_parallel", "1"])):
        ttrain.main(_train_argv(common, f"{tmp_path}/{name}/", 4) + flag)
        teval.main(_eval_argv(common, f"{tmp_path}/{name}/lstm.h5", f"{tmp_path}/{name}/res/", 1)
                   + flag)
        out[name] = [open(f"{tmp_path}/{name}/lstm.h5", "rb").read()] + [
            open(f"{tmp_path}/{name}/res/{r}").read() for r in RESULTS]
    assert out["dp"] == out["plain"]
