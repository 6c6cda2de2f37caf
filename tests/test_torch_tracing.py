"""The port's tracer (``novel_vqa_torch/core/profiling.py``): ``span`` and
``collect``, the spans at the layer boundaries, and that tracing changes
no result.

With tracing off a span records nothing and puts nothing in a profile.
With it on, each span of the calling thread is recorded with its parent,
start and end, and mirrored as an ``nvqa.*`` range into an active
``torch.profiler``.  Tiny runs of the training loops, the eval loop and
the autoencoder's validation record exactly the spans each step or batch
should have, and give bit-identical outputs with tracing on and off.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from novel_vqa_torch.core import profiling as P
from novel_vqa_torch.core.tree import tree_leaves
from novel_vqa_torch.models.seq import autoencoder as ae
from novel_vqa_torch.models.vision import vgg
from novel_vqa_torch.models.vqa import arch1
from novel_vqa_torch.ops import optim
from novel_vqa_torch.train import eval_loop
from novel_vqa_torch.train import train_text_ae as tta

TRAIN_STEP = ["train.sample", "train.forward", "lstm.encode", "train.backward",
              "train.reduce", "train.update"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _nvqa_ranges(prof):
    """The ``nvqa.*`` ranges of a finished CPU profile: (name, start, end)."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(P.PREFIX)]


def _names(rec):
    return [s[0] for s in rec.spans]


# --------------------------------------------------------------------------
# the tracer
# --------------------------------------------------------------------------

def test_off_records_nothing_and_emits_no_profiler_event():
    assert P._active is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("outer"):
            with P.span("inner"):
                torch.ones(4).sum()
    assert P._active is None
    assert _nvqa_ranges(prof) == []


def test_nesting_parents_total_and_self_time(monkeypatch):
    clock = iter([10, 12, 20, 25, 30, 31, 100, 101, 102, 104])
    monkeypatch.setattr(P.time, "perf_counter_ns", lambda: next(clock))
    with P.collect() as rec:
        with P.span("a"):  # 10 .. 31
            with P.span("b"):  # 12 .. 20
                pass
            with P.span("b"):  # 25 .. 30
                pass
        with P.span("a"):  # 100 .. 104
            with P.span("c"):  # 101 .. 102
                pass
    assert rec.spans == [["a", -1, 10, 31], ["b", 0, 12, 20], ["b", 0, 25, 30],
                         ["a", -1, 100, 104], ["c", 3, 101, 102]]
    stats = rec.stats()
    assert stats["a"] == P.Stat(count=2, total_ns=25, self_ns=11)
    assert stats["b"] == P.Stat(count=2, total_ns=13, self_ns=13)
    assert stats["c"] == P.Stat(count=1, total_ns=1, self_ns=1)
    assert P._active is None


def test_span_closes_on_an_exception():
    with P.collect() as rec:
        with pytest.raises(ValueError):
            with P.span("a"):
                with P.span("b"):
                    raise ValueError("inside")
        with P.span("c"):
            pass
    assert [(n, parent) for n, parent, _, _ in rec.spans] == [("a", -1), ("b", 0), ("c", -1)]
    assert all(e >= s > 0 for _, _, s, e in rec.spans)


def test_mirrored_ranges_nest_as_recorded():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.collect() as rec:
            with P.span("a"):
                with P.span("b"):
                    torch.ones(8).sum()
                with P.span("c"):
                    torch.ones(8).sum()
    ranges = {name: (s, e) for name, s, e in _nvqa_ranges(prof)}
    assert sorted(ranges) == ["nvqa.a", "nvqa.b", "nvqa.c"]
    a, b, c = ranges["nvqa.a"], ranges["nvqa.b"], ranges["nvqa.c"]
    assert a[0] <= b[0] <= b[1] <= c[0] <= c[1] <= a[1]
    assert [(n, parent) for n, parent, _, _ in rec.spans] == [("a", -1), ("b", 0), ("c", 0)]


def test_other_threads_are_not_recorded():
    seen = []

    def worker():
        with P.span("elsewhere"):
            seen.append(True)

    with P.collect() as rec:
        with P.span("here"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen == [True]
    assert _names(rec) == ["here"]


def test_nested_collect_yields_the_open_record():
    with P.collect() as outer:
        with P.span("a"):
            with P.collect() as inner:
                with P.span("b"):
                    pass
        assert inner is outer and P._active is outer
        with P.span("c"):
            pass
    assert _names(outer) == ["a", "b", "c"] and outer.spans[1][1] == 0
    assert P._active is None


def test_profile_dir_trace_carries_the_spans(tmp_path):
    with P.trace(str(tmp_path), torch.device("cpu")):
        with P.span("a"):
            torch.ones(8).sum()
    assert P._active is None
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "nvqa.a" for e in events)


def test_vision_stages_are_spans():
    cfg = vgg.VGGConfig(image_size=32)
    params = vgg.init_params(cfg, _gen(0), "cpu")
    x = torch.randn(1, 3, 32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            vgg.apply(params, cfg, x, "pool5")
    assert _nvqa_ranges(prof) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof, P.collect() as rec:
        with torch.inference_mode():
            vgg.apply(params, cfg, x, "pool5")
    want = [f"vgg.block{i}" for i in range(1, 6)]
    assert _names(rec) == want
    assert sorted(n for n, _, _ in _nvqa_ranges(prof)) == ["nvqa." + n for n in want]


# --------------------------------------------------------------------------
# the spans of the port's loops, at tiny sizes
# --------------------------------------------------------------------------

A1 = arch1.Arch1Config(vocab_size=40, input_encoding_size=8, rnn_size=16, rnn_layer=2,
                       nhimage=16, common_embedding_size=12, num_output=5, dropout=0.5)
AE = ae.AEConfig(vocab_size=30, input_encoding_size=8, rnn_size=12, num_layers=1,
                 seq_length=5, dropout=0.5, variant="text_nostart")


def _vqa_store(seed, n_q=40, n_im=12, L=6):
    rs = np.random.RandomState(seed)
    tokens = np.zeros((n_q, L), np.int64)
    for i, ln in enumerate(rs.randint(1, L + 1, size=n_q)):
        tokens[i, L - ln:] = rs.randint(1, A1.vocab_size + 1, size=ln)
    return {
        "tokens": torch.from_numpy(tokens),
        "image": torch.from_numpy(rs.randn(n_im, A1.nhimage).astype(np.float32)),
        "img_pos": torch.from_numpy(rs.randint(1, n_im + 1, size=n_q)),
        "answers": torch.from_numpy(rs.randint(1, A1.num_output + 1, size=n_q)),
        "mc_ans": torch.from_numpy(rs.randint(0, A1.num_output + 1, size=(n_q, 18))),
    }


def _sentences(seed, n=30):
    rs = np.random.RandomState(seed)
    rows = np.zeros((n, AE.seq_length), np.int64)
    for i, ln in enumerate(rs.randint(1, AE.seq_length + 1, size=n)):
        rows[i, :ln] = rs.randint(1, AE.vocab_size + 1, size=ln)
    return torch.from_numpy(rows)


class _Split:
    """The part of ``data/vqa.VQAData`` that ``run_full_split`` reads."""

    def __init__(self, store):
        self.store = store

    def num_examples(self, split):
        return self.store["tokens"].shape[0]

    def split_store(self, split):
        return {k: v.numpy() for k, v in self.store.items()}


def run_arch1_scan(n_steps=3):
    tx = arch1.make_optimizer(learning_rate=1e-3)
    params = arch1.init_params(A1, _gen(0), "cpu")
    return arch1.train_steps_scan(A1, tx, params, tx.init(params), _vqa_store(1), n_steps, 8,
                                  _gen(7))


def run_ae_scan(n_steps=3):
    tx = optim.chain(optim.clamp(0.1), optim.adam(1e-3, 0.8, 0.999, 1e-8))
    params = ae.init_params(AE, _gen(3), "cpu")
    return tta.train_steps_scan(AE, tx, params, tx.init(params), _sentences(5),
                                torch.tensor(0), n_steps, 8, _gen(11))


def run_full_split():
    params = arch1.init_params(A1, _gen(0), "cpu")
    return eval_loop.run_full_split(arch1, A1, params, _Split(_vqa_store(2, n_q=21)), "val", 8,
                                    device="cpu")


def _ae_batch():
    return ae.init_params(AE, _gen(3), "cpu"), _sentences(6, n=8).t().contiguous()


def run_val_nll():
    params, seq = _ae_batch()
    return tta.val_nll(AE, params, seq)


def run_greedy():
    params, seq = _ae_batch()
    return tta.greedy_tokens(AE, params, seq)


@pytest.mark.parametrize("run", [run_arch1_scan, run_ae_scan], ids=["arch1", "text_ae"])
def test_training_loops_record_each_phase_once_per_step(run):
    with P.collect() as rec:
        run(n_steps=3)
    assert _names(rec) == TRAIN_STEP * 3
    for i, (name, parent, _, _) in enumerate(rec.spans):
        want = "train.forward" if name == "lstm.encode" else None
        assert (rec.spans[parent][0] if parent >= 0 else None) == want, (i, name)
    stats = rec.stats()
    assert {n: s.count for n, s in stats.items()} == {n: 3 for n in TRAIN_STEP}
    assert stats["train.forward"].self_ns < stats["train.forward"].total_ns


def test_eval_loop_uploads_once_per_call():
    with P.collect() as rec:
        run_full_split()
        run_full_split()
    assert _names(rec).count("eval.upload") == 2
    assert all(parent == -1 for name, parent, _, _ in rec.spans if name == "eval.upload")
    # the seq kernel's caller: one encode per batch of 8 over 21 questions
    assert _names(rec).count("lstm.encode") == 2 * 3


@pytest.mark.parametrize("run,name", [(run_val_nll, "ae.nll"), (run_greedy, "ae.greedy")],
                         ids=["val_nll", "greedy_tokens"])
def test_autoencoder_validation_spans(run, name):
    with P.collect() as rec:
        run()
    assert _names(rec) == [name, "lstm.encode"]
    assert rec.spans[1][1] == 0


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, np.ndarray):
        return [torch.from_numpy(out)]
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [torch.as_tensor(x) for x in tree_leaves(out)]


@pytest.mark.parametrize("run", [run_arch1_scan, run_ae_scan, run_full_split, run_val_nll,
                                 run_greedy],
                         ids=["arch1_scan", "text_ae_scan", "run_full_split", "val_nll",
                              "greedy_tokens"])
def test_tracing_changes_no_result(run):
    off = _flat(run())
    with P.collect() as rec:
        on = _flat(run())
    assert rec.spans
    assert len(on) == len(off) > 0
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
