"""Split-quality audit tools.

Copy of ``novel_vqa_tpu.pipeline.quality_eval``: ports of
000_create_dataset/004_evaluate_quality_part{1,2}.py and
005_compute_statistics.py:

  * ``nouns``   (part 1): re-derive the noun inventory of a built novel split
    by tokenizing + POS-tagging every train/test question and its answers,
    writing ``nouns_vqa.json`` (counts included) for the leakage check
    (004_evaluate_quality_part1.py:116-209; the 12-18-worker joblib pool
    becomes a plain loop — tagging here is not the bottleneck offline);
  * ``overlap`` (part 2): intersect the derived nouns with the frozen
    trainNouns/testNouns lists and report novel-noun and pluralized-novel
    leakage counts (004_evaluate_quality_part2.py:21-53);
  * ``sizes``   (005_compute_statistics.py): print split sizes.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

from novel_vqa_torch.pipeline.pos import pluralize, pos_tag
from novel_vqa_torch.pipeline.tokenize import word_tokenize


def derive_nouns(
    items: List[dict], annotations: List[dict], tagger: str
) -> Tuple[List[str], Dict[str, int]]:
    counts: Dict[str, int] = {}
    anno_by_qid = {a["question_id"]: a for a in annotations}
    for el in items:
        toks = word_tokenize(el["question"].lower().replace("/", " "))
        words = list(toks)
        anno = anno_by_qid.get(el["ques_id"])
        if anno:
            seen = set()
            for a in anno.get("answers", []):
                for w in word_tokenize(a["answer"].lower().replace("/", " ")):
                    seen.add(w)
            words += sorted(seen)
        for w, tag in pos_tag(words, tagger):
            if tag == "NN":
                counts[w] = counts.get(w, 0) + 1
    return list(counts), counts


def run_nouns(args):
    with open(args.input_train_json) as f:
        imgs_train = json.load(f)
    with open(args.input_test_json) as f:
        imgs_test = json.load(f)
    train_anns = test_anns = []
    if args.input_train_annotations:
        with open(args.input_train_annotations) as f:
            train_anns = json.load(f)["annotations"]
    if args.input_test_annotations:
        with open(args.input_test_annotations) as f:
            test_anns = json.load(f)["annotations"]

    nouns_train, counts_train = derive_nouns(imgs_train, train_anns, args.tagger)
    nouns_test, counts_test = derive_nouns(imgs_test, test_anns, args.tagger)
    os.makedirs(args.save_path, exist_ok=True)
    out = {
        "nouns_train": nouns_train,
        "nouns_train_count": counts_train,
        "nouns_test": nouns_test,
        "nouns_test_count": counts_test,
    }
    path = os.path.join(args.save_path, "nouns_vqa.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print("wrote", path)


def run_overlap(args):
    with open(os.path.join(args.save_path, "nouns_vqa.json")) as f:
        nouns_vqa = json.load(f)
    with open(args.train_nouns) as f:
        train_nouns = set(json.load(f))
    with open(args.test_nouns) as f:
        test_nouns = set(json.load(f))
    test_plural = {pluralize(n) for n in test_nouns}

    all_train = set(nouns_vqa["nouns_train"])
    all_test = set(nouns_vqa["nouns_test"])

    novel_in_train = all_train & test_nouns
    plural_in_train = all_train & test_plural
    print("# Novel nouns in train: %d" % len(novel_in_train))
    print("Novel nouns in train: ", sorted(novel_in_train))
    print("# Plural forms of Novel nouns in train: %d" % len(plural_in_train))
    print("Plural forms of Novel nouns in train", sorted(plural_in_train))

    filtered_train = all_train & train_nouns
    filtered_test = all_test & (train_nouns | test_nouns)
    print("Number of train nouns: %d" % len(filtered_train))
    print("Number of test nouns: %d" % len(filtered_test))
    print("Number of test only nouns: %d" % len(filtered_test - filtered_train))
    print(
        "Number of nouns in both train and test: %d"
        % len(filtered_test & filtered_train)
    )
    return {
        "novel_in_train": sorted(novel_in_train),
        "plural_in_train": sorted(plural_in_train),
    }


def run_sizes(args):
    with open(args.raw_train_path) as f:
        raw_train = json.load(f)
    with open(args.raw_test_path) as f:
        raw_test = json.load(f)
    print("Number of training questions: %d" % len(raw_train))
    print("Number of testing questions: %d" % len(raw_test))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("nouns")
    p.add_argument("--input_train_json", required=True)
    p.add_argument("--input_test_json", required=True)
    p.add_argument("--input_train_annotations", default="")
    p.add_argument("--input_test_annotations", default="")
    p.add_argument("--save_path", default="preprocessed/")
    p.add_argument("--tagger", default="auto", choices=["auto", "nltk", "heuristic"])

    p = sub.add_parser("overlap")
    p.add_argument("--save_path", default="preprocessed/")
    p.add_argument("--train_nouns", default="trainNouns.json")
    p.add_argument("--test_nouns", default="testNouns.json")

    p = sub.add_parser("sizes")
    p.add_argument("--raw_train_path", required=True)
    p.add_argument("--raw_test_path", required=True)

    args = ap.parse_args(argv)
    if args.cmd == "nouns":
        run_nouns(args)
    elif args.cmd == "overlap":
        return run_overlap(args)
    else:
        run_sizes(args)


if __name__ == "__main__":
    main()
