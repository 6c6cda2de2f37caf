"""Stage L6: dataset correction (v1 -> v2 novel split).

Copy of ``novel_vqa_tpu.pipeline.correction``: Python-3 ports of
005_correction_to_dataset/:
  * ``validate``   = 000_validate_split.py: audit the v1 split for the three
    leak classes (pluralized novel forms, non-noun senses, novel words in
    answers);
  * ``correct``    = 001_create_corrected_split.py: drop train questions that
    contain pluralized novel words (question or any answer token) or whose
    answers contain a novel noun (:53-119); test set copied unchanged
    (:134-139); emits the ``*_novel_new_2*`` files;
  * ``img-lookup`` = 002_create_img_lookup.py: img_path -> {idx, set} from an
    existing prepro json (:10-26);
  * ``remap-features`` = 003_prepro_img_lookup.lua: assemble the new split's
    feature h5 from the old h5 via the lookup, avoiding fc7 re-extraction
    (:44-118) — the port's ``core/h5.py`` here, same ``/images_*`` float32
    layout: old rows read a window at a time, each split written as it is
    built.

``pluralize`` comes from pipeline/pos.py (pattern.en is unavailable offline);
the excluded stop-words list matches the reference (:23).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, List

import numpy as np

from novel_vqa_torch.core.h5 import H5Reader, update_h5, write_h5
from novel_vqa_torch.pipeline.pos import pluralize, pos_tag
from novel_vqa_torch.pipeline.tokenize import word_tokenize

REM_WORDS = ["p", "mr", "k", "someone", "g", "m", "hi", "no"]  # :23


def _load_novel_words(path: str) -> List[str]:
    with open(path) as f:
        return [x for x in json.load(f) if x not in REM_WORDS]


def _pluralized(novel_words: List[str]):
    plural_set = set()
    for word in novel_words:
        p = pluralize(word)
        if p != word:
            plural_set.add(p)
    return plural_set


def run_correct(params):
    novel_words = _load_novel_words(params["novel_words"])
    novel_set = set(novel_words)
    plural_set = _pluralized(novel_words)

    with open(params["train_raw"]) as f:
        train_raw = json.load(f)
    with open(params["train_annotations"]) as f:
        train_anno = json.load(f)["annotations"]
    with open(params["train_oe_questions"]) as f:
        train_oe = json.load(f)
    with open(params["train_mcq_questions"]) as f:
        train_mcq = json.load(f)

    def container(task_type):
        return {
            "info": [],
            "data_type": "mscoco_novel",
            "data_subtype": "train",
            "licence": [],
            "task_type": task_type,
            "questions": [],
        }

    out_raw: List[dict] = []
    out_anno = {"info": [], "data_type": "mscoco_novel", "data_subtype": "train", "annotations": []}
    out_oe = container("Open-Ended")
    out_mcq = container("Multiple-Choice")
    n_plural = n_ans = n_rejected = 0

    for el_count, el in enumerate(train_raw):
        el_anno = train_anno[el_count]["answers"]
        question_tok = word_tokenize(el["question"].lower().replace("/", " "))
        answer_set, answer_nouns = set(), set()
        for a_el in el_anno:
            a = a_el["answer"].lower().replace("/", " ")
            toks = word_tokenize(a)
            for t in toks:
                answer_set.add(t)
            for w, tag in pos_tag(toks, params["tagger"]):
                if tag == "NN":
                    answer_nouns.add(w)

        is_plural = any(
            w in plural_set for w in question_tok + list(answer_set)
        )
        is_ans_novel = any(w in novel_set for w in answer_nouns)

        if not is_plural and not is_ans_novel:
            out_raw.append(el)
            out_anno["annotations"].append(train_anno[el_count])
            out_oe["questions"].append(train_oe["questions"][el_count])
            out_mcq["questions"].append(train_mcq["questions"][el_count])
        else:
            n_rejected += 1
        n_plural += int(is_plural)
        n_ans += int(is_ans_novel)

    os.makedirs(os.path.dirname(params["save_train_raw"]) or ".", exist_ok=True)
    for obj, path in (
        (out_raw, params["save_train_raw"]),
        (out_anno, params["save_train_annotations"]),
        (out_oe, params["save_train_oe_questions"]),
        (out_mcq, params["save_train_mcq_questions"]),
    ):
        with open(path, "w") as f:
            json.dump(obj, f)

    # test set unchanged: copy (:134-139)
    for src_key, dst_key in (
        ("test_raw", "save_test_raw"),
        ("test_annotations", "save_test_annotations"),
        ("test_oe_questions", "save_test_oe_questions"),
        ("test_mcq_questions", "save_test_mcq_questions"),
    ):
        if params.get(src_key) and params.get(dst_key):
            shutil.copy(params[src_key], params[dst_key])

    print("Number of plural train questions", n_plural)
    print("Number of novel answer train questions", n_ans)
    print("Number of train questions rejected", n_rejected)


def run_img_lookup(params):
    with open(params["original_json"]) as f:
        original = json.load(f)
    lookup: Dict[str, dict] = {}
    for i, img in enumerate(original["unique_img_train"]):
        lookup[img] = {"idx": i + 1, "set": "train"}
    for i, img in enumerate(original["unique_img_val"]):
        if img not in lookup:
            lookup[img] = {"idx": i + 1, "set": "val"}
    for i, img in enumerate(original["unique_img_test"]):
        if img not in lookup:
            lookup[img] = {"idx": i + 1, "set": "test"}
    with open(params["save_path"], "w") as f:
        json.dump(lookup, f)
    print("wrote", params["save_path"])


def run_remap_features(params):
    """003_prepro_img_lookup.lua:44-118: build the new split's feature h5 by
    copying rows from the old h5 through the img_path lookup."""
    with open(params["lookup_json"]) as f:
        lookup = json.load(f)
    with open(params["new_prepro_json"]) as f:
        new_meta = json.load(f)

    write_h5(params["out_h5"], {})  # h5py's mode "w": a new, empty file
    with H5Reader(params["old_img_h5"]) as old:
        old_feats = {
            s: old.dataset(f"images_{s}") for s in ("train", "val", "test") if f"images_{s}" in old
        }
        for split in ("train", "val", "test"):
            img_list = new_meta.get(f"unique_img_{split}", [])
            if not img_list:
                continue
            ndims = next(iter(old_feats.values())).shape[1]
            feats = np.zeros((len(img_list), ndims), np.float32)
            misses = 0
            for i, img in enumerate(img_list):
                rec = lookup.get(img)
                if rec is None:
                    misses += 1
                    continue
                row = rec["idx"] - 1
                feats[i] = old_feats[rec["set"]][row : row + 1][0]
            if misses:
                print(f"WARNING: {misses} images missing from lookup in {split}")
            update_h5(params["out_h5"], {f"images_{split}": feats})
    print("wrote", params["out_h5"])


def run_validate(params):
    """000_validate_split.py: report the three leak classes in a v1 split."""
    novel_words = _load_novel_words(params["novel_words"])
    novel_set = set(novel_words)
    plural_set = _pluralized(novel_words)

    with open(params["train_raw"]) as f:
        train_raw = json.load(f)
    with open(params["train_annotations"]) as f:
        train_anno = json.load(f)["annotations"]

    n_plural = n_ans_novel = 0
    for el_count, el in enumerate(train_raw):
        toks = word_tokenize(el["question"].lower().replace("/", " "))
        if any(w in plural_set for w in toks):
            n_plural += 1
        for a_el in train_anno[el_count]["answers"]:
            a_toks = word_tokenize(a_el["answer"].lower().replace("/", " "))
            if any(w in novel_set or w in plural_set for w in a_toks):
                n_ans_novel += 1
                break
    print(f"train questions with pluralized novel words: {n_plural}")
    print(f"train questions with novel words in answers: {n_ans_novel}")
    return {"plural": n_plural, "ans_novel": n_ans_novel}


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("correct")
    p.add_argument("--novel_words", required=True)
    p.add_argument("--train_raw", required=True)
    p.add_argument("--train_annotations", required=True)
    p.add_argument("--train_oe_questions", required=True)
    p.add_argument("--train_mcq_questions", required=True)
    p.add_argument("--save_train_raw", required=True)
    p.add_argument("--save_train_annotations", required=True)
    p.add_argument("--save_train_oe_questions", required=True)
    p.add_argument("--save_train_mcq_questions", required=True)
    for k in ("test_raw", "test_annotations", "test_oe_questions", "test_mcq_questions"):
        p.add_argument(f"--{k}", default="")
        p.add_argument(f"--save_{k}", default="")
    p.add_argument("--tagger", default="auto", choices=["auto", "nltk", "heuristic"])

    p = sub.add_parser("img-lookup")
    p.add_argument("--original_json", required=True)
    p.add_argument("--save_path", required=True)

    p = sub.add_parser("remap-features")
    p.add_argument("--lookup_json", required=True)
    p.add_argument("--new_prepro_json", required=True)
    p.add_argument("--old_img_h5", required=True)
    p.add_argument("--out_h5", required=True)

    p = sub.add_parser("validate")
    p.add_argument("--novel_words", required=True)
    p.add_argument("--train_raw", required=True)
    p.add_argument("--train_annotations", required=True)

    args = parser.parse_args(argv)
    params = vars(args)
    if args.cmd == "correct":
        run_correct(params)
    elif args.cmd == "img-lookup":
        run_img_lookup(params)
    elif args.cmd == "remap-features":
        run_remap_features(params)
    else:
        run_validate(params)


if __name__ == "__main__":
    cli()
