"""Corpus-level BLEU and CIDEr-D for autoencoder sample evaluation (copy of
``novel_vqa_tpu.eval.language_metrics``, standard library only).

The reference's ``net_utils.language_eval`` shells out to the coco-caption
toolkit (misc/net_utils.lua:326-334) to score AE reconstructions, and the AE
trainers can gate best-checkpoints on CIDEr
(001_train_arch1_text_autoencoder.lua:296-318).  coco-caption is unavailable
offline, so this module implements the two metrics the gating uses:

  * BLEU-n: corpus-level modified n-gram precision with brevity penalty
    (Papineni et al. 2002) — geometric mean over 1..n, matching coco-caption's
    Bleu output semantics for the single-reference case;
  * CIDEr-D: TF-IDF-weighted n-gram cosine similarity averaged over n=1..4,
    with length gaussian penalty and the x10 scaling (Vedantam et al. 2015).

``language_eval(predictions)`` mirrors the reference entry structure
(``{prediction, actual}`` pairs from eval_split) and returns
``{"Bleu_1"..., "CIDEr": ...}``.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    candidates: List[List[str]], references: List[List[str]], max_n: int = 4
) -> Dict[str, float]:
    """Corpus BLEU-1..max_n, single reference per candidate.

    Exact coco-caption ``bleu_scorer.py`` semantics (validated against an
    independently hand-executed oracle in tests/test_language_metrics_coco.py):
    cumulative geometric mean of the smoothed precisions
    ``(correct + tiny) / (guess + small)`` with tiny=1e-15 / small=1e-9, and
    the brevity penalty ``exp(1 - 1/ratio)`` applied to every order when
    ``ratio = (testlen + tiny) / (reflen + small) < 1`` (single reference =
    the "closest" reference length)."""
    assert len(candidates) == len(references)
    tiny, small = 1e-15, 1e-9  # bleu_scorer.py smoothing constants
    out = {}
    clipped = [0] * max_n
    total = [0] * max_n
    cand_len = sum(len(c) for c in candidates)
    ref_len = sum(len(r) for r in references)
    for cand, ref in zip(candidates, references):
        for n in range(1, max_n + 1):
            cg = _ngrams(cand, n)
            rg = _ngrams(ref, n)
            total[n - 1] += sum(cg.values())
            clipped[n - 1] += sum(min(c, rg[g]) for g, c in cg.items())
    ratio = (cand_len + tiny) / (ref_len + small)
    bp = 1.0 if ratio >= 1 else math.exp(1 - 1 / ratio)
    prod = 1.0
    for n in range(1, max_n + 1):
        prod *= (clipped[n - 1] + tiny) / (total[n - 1] + small)
        out[f"Bleu_{n}"] = bp * prod ** (1.0 / n)
    return out


def cider_d(
    candidates: List[List[str]],
    references: List[List[str]],
    max_n: int = 4,
    sigma: float = 6.0,
) -> float:
    """CIDEr-D with a single reference per candidate."""
    assert len(candidates) == len(references)
    m = len(references)
    # document frequency over reference n-grams
    df: List[Dict[Tuple[str, ...], int]] = [defaultdict(int) for _ in range(max_n)]
    for ref in references:
        for n in range(1, max_n + 1):
            for g in set(_ngrams(ref, n)):
                df[n - 1][g] += 1

    def tfidf_vec(tokens, n):
        counts = _ngrams(tokens, n)
        vec = {}
        norm = 0.0
        for g, tf in counts.items():
            idf = math.log(max(1.0, m) / max(1.0, df[n - 1].get(g, 0))) if df[
                n - 1
            ].get(g, 0) > 0 else math.log(max(1.0, m))
            w = tf * idf
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for cand, ref in zip(candidates, references):
        score_n = []
        delta = len(cand) - len(ref)
        len_pen = math.exp(-(delta**2) / (2 * sigma**2))
        for n in range(1, max_n + 1):
            cv, cn = tfidf_vec(cand, n)
            rv, rn = tfidf_vec(ref, n)
            if cn == 0 or rn == 0:
                score_n.append(0.0)
                continue
            # CIDEr-D clips candidate counts at reference counts via min
            num = sum(min(w, rv.get(g, 0.0)) * rv.get(g, 0.0) for g, w in cv.items())
            score_n.append(len_pen * num / (cn * rn))
        scores.append(10.0 * sum(score_n) / max_n)
    return sum(scores) / max(1, len(scores))


def language_eval(predictions: List[dict]) -> Dict[str, float]:
    """predictions: list of {"prediction": str, "actual": str} entries (the
    eval_split sample records).  Returns Bleu_1..4 + CIDEr."""
    cands = [p["prediction"].split() for p in predictions]
    refs = [p["actual"].split() for p in predictions]
    out = corpus_bleu(cands, refs)
    out["CIDEr"] = cider_d(cands, refs)
    return out
