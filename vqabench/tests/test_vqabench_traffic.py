"""The traffic generators: word ids by Zipf's law, and lengths whose
multiset every seed shares, on the CPU at a small size."""

import pytest
import torch

from vqabench import lengths as L
from vqabench import words as W
from vqabench.traffic import sentence_store, vqa_store

ZIPF = {"kind": "zipf", "exponent": 1.0}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_zipf_shares_fall_as_one_over_rank():
    p = W.shares(ZIPF, 1000)
    harmonic = sum(1.0 / r for r in range(1, 1001))
    assert float(p.sum()) == pytest.approx(1.0, abs=1e-12)
    assert float(p[0]) == pytest.approx(1.0 / harmonic, rel=1e-12)
    assert float(p[0] / p[9]) == pytest.approx(10.0, rel=1e-12)


def test_zipf_draws_repeat_ids_as_text_does():
    ids = W.draw(ZIPF, (4000, 50), 1000, _gen(7), "cpu")
    assert ids.dtype == torch.int32 and int(ids.min()) >= 1 and int(ids.max()) <= 1000
    counts = torch.bincount(ids.flatten().long(), minlength=1001)[1:].double() / ids.numel()
    p = W.shares(ZIPF, 1000)
    assert float((counts[:5] - p[:5]).abs().max()) < 0.003  # about 4 sd of 200,000 draws
    assert torch.equal(ids, W.draw(ZIPF, (4000, 50), 1000, _gen(7), "cpu"))
    assert not torch.equal(ids, W.draw(ZIPF, (4000, 50), 1000, _gen(8), "cpu"))
    with pytest.raises(ValueError):
        W.draw({"kind": "uniform"}, (4,), 10, _gen(7), "cpu")


@pytest.mark.parametrize("spec", [
    {"kind": "poisson", "shift": 1, "mean": 5.2, "max": 16},
    {"kind": "negbinom", "shift": 1, "mean": 12.31, "shape": 4, "max": 16},
])
def test_every_seed_draws_the_same_lengths_in_another_order(spec):
    a, b = L.draw(spec, 5000, _gen(1), "cpu"), L.draw(spec, 5000, _gen(2), "cpu")
    assert torch.equal(torch.sort(a).values, torch.sort(b).values)
    assert not torch.equal(a, b)
    assert int(a.min()) >= 1 and int(a.max()) <= 16
    assert sum(L.counts(spec, 5000)) == 5000


def test_the_stores_place_zipf_words_at_their_lengths():
    cfg = {"vocab_size": 300, "seq_length": 16, "nhimage": 8}
    lengths = {"kind": "poisson", "shift": 1, "mean": 5.2, "max": 16}
    q = vqa_store.make({"questions": 3000, "images": 20, "answers": 10, "mc_choices": 0,
                        "lengths": lengths, "words": ZIPF}, cfg, _gen(3), "cpu")
    steps = torch.arange(16)[None, :]
    assert torch.equal(q["tokens"] != 0, steps >= 16 - q["lengths"][:, None])
    s = sentence_store.make({"rows": 3000, "lengths": lengths, "words": ZIPF}, cfg, _gen(3), "cpu")
    assert torch.equal(s["rows"] != 0, steps < s["lengths"][:, None])
    for tokens in (q["tokens"], s["rows"]):
        counts = torch.bincount(tokens.flatten().long(), minlength=301)[1:]
        assert int(counts.argmax()) == 0 and counts[0] > 5 * counts[9]
