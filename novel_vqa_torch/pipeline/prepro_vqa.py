"""VQA preprocessing: raw train/test JSON -> data_prepro.{json,h5}.

Copy of ``novel_vqa_tpu.pipeline.prepro_vqa``, writing its h5 through the
port's ``core/h5.py`` (the machine with the card has no h5py).  Python-3
port of 002_train_vqa_arch1/000_prepro_vqa.py (= arch1; arch2's copy
at 003_train_vqa_arch2/000_prepro_vqa.py differs only in tokenization —
``--token_method treebank`` — and in lacking the external answer vocab
branch).  Byte-identical h5 schema (:273-293): uint32 ``ques_*``,
``ques_length_*``, ``question_id_*``, ``img_pos_*``, ``answers``,
``answers_val``, ``MC_ans_test``; json ``ix_to_word``/``ix_to_ans``/
``unique_img_*`` (:297-305).

Reference quirks preserved deliberately (SURVEY.md section 7):
  * ``num_val`` off-by-one: ``imgs_train[0:-(num_val-1)]`` leaves one example
    in BOTH train and val (:241-244);
  * out-of-vocab answers encode to 0 when an external answer vocab is used
    (:161-173);
  * 1-indexed vocab/img_pos (torch convention).

Known deviations (statistical parity only, documented):
  * ``random.shuffle`` under Python 3 yields a different permutation for seed
    123 than Python 2 did — which tail becomes the val carve-out differs;
  * from-scratch (non-external) vocab ordering follows first-occurrence order
    instead of py2 hash order — same vocab *set*, different index labels.
Both are irrelevant when the frozen ``vocabs/`` and split JSONs are supplied
via ``--extern_vocab``/``--extern_ans_vocab`` (the published flow).
"""

from __future__ import annotations

import argparse
import json
from random import seed, shuffle
from typing import Dict, List

import numpy as np

from novel_vqa_torch.core.h5 import write_h5
from novel_vqa_torch.pipeline.tokenize import get_tokenizer


def prepro_question(imgs: List[dict], params) -> List[dict]:
    tok = get_tokenizer(params["token_method"])
    for i, img in enumerate(imgs):
        img["processed_tokens"] = tok(img["question"])
        if i < 10:
            print(img["processed_tokens"])
    return imgs


def build_vocab_question(imgs, params):
    if params["extern_vocab"] == "":
        count_thr = params["word_count_threshold"]
        counts: Dict[str, int] = {}
        for img in imgs:
            for w in img["processed_tokens"]:
                counts[w] = counts.get(w, 0) + 1
        cw = sorted([(count, w) for w, count in counts.items()], reverse=True)
        print("top words and their counts:")
        print("\n".join(map(str, cw[:20])))
        total_words = sum(counts.values())
        bad_words = [w for w, n in counts.items() if n <= count_thr]
        vocab = [w for w, n in counts.items() if n > count_thr]
        bad_count = sum(counts[w] for w in bad_words)
        print(
            "number of bad words: %d/%d = %.2f%%"
            % (len(bad_words), len(counts), len(bad_words) * 100.0 / len(counts))
        )
        print("number of words in vocab would be %d" % len(vocab))
        print(
            "number of UNKs: %d/%d = %.2f%%"
            % (bad_count, total_words, bad_count * 100.0 / total_words)
        )
        vocab.append("UNK")
        for img in imgs:
            txt = img["processed_tokens"]
            img["final_question"] = [
                w if counts.get(w, 0) > count_thr else "UNK" for w in txt
            ]
    else:
        with open(params["extern_vocab"]) as f:
            vocab = json.load(f)
        vocab_set = set(vocab)
        print("inserting the special UNK token")
        for img in imgs:
            txt = img["processed_tokens"]
            img["final_question"] = [w if w in vocab_set else "UNK" for w in txt]
    return imgs, vocab


def apply_vocab_question(imgs, wtoi):
    for img in imgs:
        txt = img["processed_tokens"]
        img["final_question"] = [w if w in wtoi else "UNK" for w in txt]
    return imgs


def get_top_answers(imgs, params):
    if params["extern_ans_vocab"] == "":
        counts: Dict[str, int] = {}
        for img in imgs:
            counts[img["ans"]] = counts.get(img["ans"], 0) + 1
        cw = sorted([(count, w) for w, count in counts.items()], reverse=True)
        print("top answer and their counts:")
        print("\n".join(map(str, cw[:20])))
        if len(cw) < params["num_ans"]:
            raise ValueError(
                f"--num_ans {params['num_ans']} but only {len(cw)} distinct "
                "answers in the training data (the reference crashes with an "
                "opaque IndexError here)"
            )
        return [cw[i][1] for i in range(params["num_ans"])]
    with open(params["extern_ans_vocab"]) as f:
        return json.load(f)


def encode_question(imgs, params, wtoi):
    max_length = params["max_length"]
    N = len(imgs)
    label_arrays = np.zeros((N, max_length), dtype="uint32")
    label_length = np.zeros(N, dtype="uint32")
    question_id = np.zeros(N, dtype="uint32")
    for i, img in enumerate(imgs):
        question_id[i] = img["ques_id"]
        label_length[i] = min(max_length, len(img["final_question"]))
        for k, w in enumerate(img["final_question"]):
            if k < max_length:
                label_arrays[i, k] = wtoi[w]
                assert label_arrays[i, k] != 0, "0 token encoded (1-indexed vocab)"
    return label_arrays, label_length, question_id


def encode_answer(imgs, atoi):
    # out-of-vocab answers -> 0 (:161-173, quirk preserved)
    return np.asarray(
        [atoi.get(img["ans"], 0) for img in imgs], dtype="uint32"
    )


def encode_mc_answer(imgs, atoi):
    N = len(imgs)
    mc = np.zeros((N, 18), dtype="uint32")
    for i, img in enumerate(imgs):
        for j, ans in enumerate(img["MC_ans"]):
            mc[i, j] = atoi.get(ans, 0)
    return mc


def filter_question(imgs, atoi):
    new_imgs = [img for img in imgs if img["ans"] in atoi]
    print("question number reduce from %d to %d " % (len(imgs), len(new_imgs)))
    return new_imgs


def get_unique_img(imgs):
    count_img: Dict[str, int] = {}
    N = len(imgs)
    img_pos = np.zeros(N, dtype="uint32")
    for img in imgs:
        count_img[img["img_path"]] = count_img.get(img["img_path"], 0) + 1
    unique_img = list(count_img.keys())  # first-occurrence order
    imgtoi = {w: i + 1 for i, w in enumerate(unique_img)}  # 1-indexed for torch
    for i, img in enumerate(imgs):
        img_pos[i] = imgtoi[img["img_path"]]
    return unique_img, img_pos


def main(params):
    with open(params["input_train_json"]) as f:
        imgs_train = json.load(f)
    with open(params["input_test_json"]) as f:
        imgs_test = json.load(f)

    top_ans = get_top_answers(imgs_train, params)
    atoi = {w: i + 1 for i, w in enumerate(top_ans)}
    itoa = {i + 1: w for i, w in enumerate(top_ans)}

    imgs_train = filter_question(imgs_train, atoi)

    seed(123)  # make reproducible
    shuffle(imgs_train)

    imgs_train = prepro_question(imgs_train, params)
    imgs_test = prepro_question(imgs_test, params)

    imgs_train, vocab = build_vocab_question(imgs_train, params)
    imgs_val = []
    if params["num_val"] > 0:
        num_val = params["num_val"]
        imgs_val = imgs_train[-num_val:]
        # off-by-one preserved: one example lands in BOTH train and val (:244)
        imgs_train = imgs_train[0 : -(num_val - 1)]

    itow = {i + 1: w for i, w in enumerate(vocab)}
    wtoi = {w: i + 1 for i, w in enumerate(vocab)}

    imgs_test = apply_vocab_question(imgs_test, wtoi)
    ques_test, ques_length_test, question_id_test = encode_question(
        imgs_test, params, wtoi
    )
    ques_train, ques_length_train, question_id_train = encode_question(
        imgs_train, params, wtoi
    )
    if params["num_val"] > 0:
        ques_val, ques_length_val, question_id_val = encode_question(
            imgs_val, params, wtoi
        )

    print("Number of train: %d" % len(imgs_train))
    print("Number of val  : %d" % len(imgs_val))
    print("Number of test : %d" % len(imgs_test))

    unique_img_train, img_pos_train = get_unique_img(imgs_train)
    if params["num_val"] > 0:
        unique_img_val, img_pos_val = get_unique_img(imgs_val)
    unique_img_test, img_pos_test = get_unique_img(imgs_test)

    A = encode_answer(imgs_train, atoi)
    A_val = encode_answer(imgs_val, atoi)
    MC_ans_test = encode_mc_answer(imgs_test, atoi)

    arrays = {
        "ques_train": ques_train,
        "ques_length_train": ques_length_train,
        "answers": A,
        "question_id_train": question_id_train,
        "img_pos_train": img_pos_train,
    }
    if params["num_val"] > 0:
        arrays.update({
            "ques_val": ques_val,
            "ques_length_val": ques_length_val,
            "answers_val": A_val,
            "question_id_val": question_id_val,
            "img_pos_val": img_pos_val,
        })
    arrays.update({
        "ques_test": ques_test,
        "ques_length_test": ques_length_test,
        "question_id_test": question_id_test,
        "img_pos_test": img_pos_test,
        "MC_ans_test": MC_ans_test,
    })
    write_h5(params["output_h5"], {k: np.asarray(v, np.uint32) for k, v in arrays.items()})
    print("wrote", params["output_h5"])

    out = {
        "ix_to_word": itow,
        "ix_to_ans": itoa,
        "unique_img_train": unique_img_train,
        "unique_img_val": unique_img_val if params["num_val"] > 0 else [],
        "unique_img_test": unique_img_test,
    }
    with open(params["output_json"], "w") as f:
        json.dump(out, f)
    print("wrote", params["output_json"])
    return vocab, top_ans


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_train_json", required=True)
    parser.add_argument("--input_test_json", required=True)
    parser.add_argument("--num_ans", required=True, type=int)
    parser.add_argument("--output_json", default="data_prepro.json")
    parser.add_argument("--output_h5", default="data_prepro.h5")
    parser.add_argument("--max_length", default=16, type=int)
    parser.add_argument("--word_count_threshold", default=0, type=int)
    parser.add_argument("--num_val", default=0, type=int)
    parser.add_argument(
        "--token_method",
        default="nltk",
        help="nltk (= arch1 punct-strip) | treebank (= arch2 word_tokenize) | regex",
    )
    parser.add_argument("--extern_vocab", default="")
    parser.add_argument("--extern_ans_vocab", default="")
    parser.add_argument("--save_vocab", default=0, type=int)
    parser.add_argument("--vocab_save_path", default="vocab.json")
    parser.add_argument("--ans_vocab_save_path", default="ans.json")
    args = parser.parse_args(argv)
    params = vars(args)
    print("parsed input parameters:")
    print(json.dumps(params, indent=2))
    vocab, top_ans = main(params)
    if params["save_vocab"] == 1:
        with open(params["vocab_save_path"], "w") as f:
            json.dump(vocab, f)
        with open(params["ans_vocab_save_path"], "w") as f:
            json.dump(top_ans, f)


if __name__ == "__main__":
    cli()
