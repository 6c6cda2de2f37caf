"""Text-corpus preprocessing: BookCorpus(/Wikipedia) -> data.{h5,json}.

Copy of ``novel_vqa_tpu.pipeline.prepro_book_corpus``, writing its h5
through the port's ``core/h5.py`` (groups ``labels/*``, ``label_length/*``).
Python-3 port of 001_train_autoencoder/000_prepro_book_corpus.py (and its
_and_wikipedia variant — pass extra files via repeated ``--corpus``).
Byte-identical h5 schema (:343-356): ``labels/{train,val,test}`` uint32
(N, max_length), ``label_length/*`` uint32; json ``ix_to_word`` (1-indexed),
``num_{train,val,test}`` (:362-368).  Conventions: token 0 = null/END pad,
START = vocab+1 (:156-160); the first num_val sentences are val, the next
num_test are test, the rest train (:322-331).

Vocab construction (:83-176): count words; start from the injected VQA vocab
plus novel-words vocab; add words above the count threshold, capped at
``max_vocab_size`` by keeping the most frequent; append UNK when any word got
dropped.  Deviation (documented): the reference materializes the vocab as a
py2 ``set`` whose iteration order fixed the published index labels; here an
insertion-ordered dict gives a *deterministic* order (same vocab set, stable
across runs — py3 set order is hash-randomized).  The published frozen vocabs
load via ``--ext_vocab`` unchanged.
"""

from __future__ import annotations

import argparse
import json
from random import seed, shuffle
from typing import Dict, List

import numpy as np

from novel_vqa_torch.core.h5 import write_h5
from novel_vqa_torch.pipeline.tokenize import prepro_sentence_ascii


def create_vocab(dataset, params) -> List[str]:
    if params["ext_vocab"] == "":
        count_thr = params["word_count_threshold"]
        word_count: Dict[str, int] = {}
        for sent in dataset["tokenized"]:
            for word in sent:
                word_count[word] = word_count.get(word, 0) + 1

        total_words = sum(word_count.values())
        print("Total words:", total_words)

        vocab: Dict[str, None] = {}  # insertion-ordered set
        if params["vqa_vocab"]:
            print("Adding words from vqa vocabulary")
            with open(params["vqa_vocab"]) as f:
                for w in json.load(f):
                    vocab[w] = None
        if params["novel_vocab"]:
            print("Adding novel words from vqa dataset")
            with open(params["novel_vocab"]) as f:
                for w in json.load(f):
                    vocab[w] = None

        vocab_update = [w for w, n in word_count.items() if n > count_thr]
        unk_words = [
            w for w, n in word_count.items() if n <= count_thr and w not in vocab
        ]
        if len(vocab_update) > params["max_vocab_size"]:
            ranked = sorted(
                [(word_count[w], w) for w in vocab_update], reverse=True
            )
            vocab_update = [w for _, w in ranked[: params["max_vocab_size"]]]
            unk_words += [w for _, w in ranked[params["max_vocab_size"] :]]
        unk_words = [w for w in unk_words if w not in vocab]
        for w in vocab_update:
            vocab[w] = None
        vocab_list = list(vocab)

        unk_count = sum(word_count.get(w, 0) for w in unk_words)
        print(
            "Number of bad words: %d/%d = %.2f%%"
            % (
                len(unk_words),
                len(word_count),
                len(unk_words) * 100.0 / max(1, len(word_count)),
            )
        )
        print("Number of words in vocab: %d" % len(vocab_list))
        print(
            "Number of UNKs: %d/%d = %.2f%%"
            % (unk_count, total_words, unk_count * 100.0 / max(1, total_words))
        )

        if unk_count > 0:
            print("inserting the special UNK token")
            vocab_list.append("UNK")

        vocab_set = set(vocab_list)
        dataset["final"] = [
            [w if w in vocab_set else "UNK" for w in sent]
            for sent in dataset["tokenized"]
        ]
        return vocab_list
    else:
        print("Found external vocabulary")
        with open(params["ext_vocab"]) as f:
            vocab_list = json.load(f)
        vocab_set = set(vocab_list)
        dataset["final"] = [
            [w if w in vocab_set else "UNK" for w in sent]
            for sent in dataset["tokenized"]
        ]
        return vocab_list


def encode_split(dataset, params, wtoi, split):
    """encode_sentences_less_memory (:213-254)."""
    max_length = params["max_length"]
    idxs = [i for i, s in enumerate(dataset["split"]) if s == split]
    L = np.zeros((len(idxs), max_length), dtype="uint32")
    lengths = np.zeros((len(idxs),), dtype="uint32")
    for row, i in enumerate(idxs):
        sent = dataset["final"][i]
        for k, w in enumerate(sent):
            if k < max_length:
                L[row, k] = wtoi[w]
        lengths[row] = min(max_length, len(sent))
    assert np.all(lengths > 0), "Error: Some captions had no words!"
    return L, lengths


def main(params):
    seed(123)  # :16
    dataset = {"unprocessed": [], "tokenized": []}
    for path in params["corpus"]:
        with open(path, errors="ignore") as f:
            for line in f:
                dataset["unprocessed"].append(line.replace("\n", ""))
    print(f"read {len(dataset['unprocessed'])} sentences")
    shuffle(dataset["unprocessed"])
    dataset["tokenized"] = [
        prepro_sentence_ascii(s) for s in dataset["unprocessed"]
    ]
    # drop empties early? the reference keeps them and crashes in the length
    # assert; we keep the assert semantics but filter blank raw lines, which
    # the reference corpus did not contain
    keep = [i for i, t in enumerate(dataset["tokenized"]) if len(t) > 0]
    if len(keep) != len(dataset["tokenized"]):
        print(f"dropping {len(dataset['tokenized']) - len(keep)} empty sentences")
        dataset["unprocessed"] = [dataset["unprocessed"][i] for i in keep]
        dataset["tokenized"] = [dataset["tokenized"][i] for i in keep]

    vocab = create_vocab(dataset, params)
    itow = {i + 1: w for i, w in enumerate(vocab)}
    wtoi = {w: i + 1 for i, w in enumerate(vocab)}

    dataset["split"] = []
    for i in range(len(dataset["final"])):
        if i < params["num_val"]:
            dataset["split"].append("val")
        elif i < params["num_val"] + params["num_test"]:
            dataset["split"].append("test")
        else:
            dataset["split"].append("train")

    arrays = {}
    for split in ("train", "val", "test"):
        L, lengths = encode_split(dataset, params, wtoi, split)
        arrays[f"labels/{split}"] = L
        arrays[f"label_length/{split}"] = lengths
    write_h5(params["output_h5"], arrays)
    print("wrote", params["output_h5"])

    out = {
        "num_test": params["num_test"],
        "num_val": params["num_val"],
        "num_train": len(dataset["final"]) - params["num_test"] - params["num_val"],
        "ix_to_word": itow,
    }
    with open(params["output_json"], "w") as f:
        json.dump(out, f)
    print("wrote", params["output_json"])
    return vocab


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--word_count_threshold", default=5, type=int)
    parser.add_argument("--max_length", default=16, type=int)
    parser.add_argument("--output_h5", default="data.h5")
    parser.add_argument("--output_json", default="data.json")
    parser.add_argument("--num_val", default=30000, type=int)
    parser.add_argument("--num_test", default=100000, type=int)
    parser.add_argument("--max_vocab_size", default=20000, type=int)
    parser.add_argument("--ext_vocab", default="")
    parser.add_argument("--vqa_vocab", default="", help="inject the VQA question vocab")
    parser.add_argument("--novel_vocab", default="", help="inject the novel-words vocab")
    parser.add_argument(
        "--corpus",
        action="append",
        required=True,
        help="corpus text file (repeat for BookCorpus parts / Wikipedia)",
    )
    args = parser.parse_args(argv)
    return main(vars(args))


if __name__ == "__main__":
    cli()
