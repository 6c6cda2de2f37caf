"""Stage L1: novel-split construction — statistics, clustering, split build.

Copy of ``novel_vqa_tpu.pipeline.novel_split``.  Three CLI entry points,
Python-3 ports of 000_create_dataset/00{1,2,3}:

  * ``stats``   = 001_create_novel_statistics.py: POS-tag every train+val
    question, histogram NN nouns over the 64 question types (longest-prefix
    match, :47-63), filter nouns with < 10 occurrences (:186-188), and emit
    norm-squared-normalized feature vectors (:194-199 — the reference divides
    by the *squared* L2 norm; preserved);
  * ``cluster`` = 002_cluster_novel_words.py: KMeans k=14, k-means++,
    n_init=400, max_iter=5000 over the feature vectors (:61), emitting
    clusteredNouns/clusterCenters JSONs + ClusterStatistics.txt (:105-121);
  * ``split``   = 003_create_novel_vqa_split.py: seeded per-cluster 80/20
    shuffle split of nouns (:32-42, including the off-by-one that drops
    element ``numOld`` from both sides), then route every QA pair whose
    question or any answer contains a test noun to novel-val (:71-178), with
    majority-answer selection for val-origin items (:128-141); emits the raw
    + annotation + OE/MC question JSONs (:190-197).
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import Dict, List

from novel_vqa_torch.pipeline.pos import pos_tag
from novel_vqa_torch.pipeline.tokenize import word_tokenize


def get_question_type(question: List[str], q_types: List[List[str]]) -> int:
    """Longest-first prefix match (001_create_novel_statistics.py:47-63)."""
    for q_no, q in enumerate(q_types):
        check = 1
        for i in range(min(len(q), len(question))):
            if q[i] != question[i]:
                check = 0
        if check == 1:
            return q_no
    return -1


def load_question_types(path: str) -> List[List[str]]:
    q_types = []
    with open(path) as f:
        for line in f:
            q_types.append(line.replace("\n", "").split())
    return sorted(q_types, key=len, reverse=True)


def _question_nouns(question_text: str, tagger: str) -> List[str]:
    question = word_tokenize(question_text.lower().replace("/", " "))
    return question, [t[0] for t in pos_tag(question, tagger) if t[1] == "NN"]


def run_stats(params):
    os.makedirs(params["out_dir"], exist_ok=True)
    q_types = load_question_types(params["question_types"])
    num_q_types = len(q_types)
    with open(os.path.join(params["out_dir"], "questionTypes.json"), "w") as f:
        json.dump([" ".join(x) for x in q_types], f)

    stats: Dict[str, List[int]] = {}
    ques: Dict[str, List[List[int]]] = {}

    def process(data_list):
        for el in data_list:
            question, nouns = _question_nouns(el["question"], params["tagger"])
            q_type = get_question_type(question, q_types)
            for n in nouns:
                stats.setdefault(n, [0] * num_q_types)[q_type] += 1
                ques.setdefault(n, [[] for _ in range(num_q_types)])[q_type].append(
                    el["ques_id"]
                )

    with open(params["raw_train"]) as f:
        process(json.load(f))
    with open(params["raw_test"]) as f:
        process(json.load(f))

    with open(os.path.join(params["out_dir"], "statsDict.json"), "w") as f:
        json.dump(stats, f)
    with open(os.path.join(params["out_dir"], "quesStatsDict.json"), "w") as f:
        json.dump(ques, f)

    filt = {n: h for n, h in stats.items() if sum(h) >= params["min_count"]}
    with open(os.path.join(params["out_dir"], "filtStatsDict.json"), "w") as f:
        json.dump(filt, f)

    # norm-squared normalization, exactly as the reference (:197-198)
    features = {}
    for noun, hist in filt.items():
        norm2 = sum(float(c) ** 2 for c in hist)
        features[noun] = [float(c) / norm2 for c in hist]
    with open(os.path.join(params["out_dir"], "featureVectors.json"), "w") as f:
        json.dump(features, f)
    print(f"{len(stats)} nouns, {len(filt)} after min-count filter")


def run_cluster(params):
    import numpy as np
    from sklearn.cluster import KMeans

    with open(os.path.join(params["stats_dir"], "featureVectors.json")) as f:
        features = json.load(f)
    os.makedirs(params["out_dir"], exist_ok=True)

    names = list(features)
    X = np.asarray([features[n] for n in names])
    est = KMeans(
        init="k-means++",
        n_clusters=params["num_clusters"],
        n_init=params["n_init"],
        max_iter=params["max_iter"],
        random_state=params["seed"],  # the reference set none (:2); fixed here
    )
    est.fit(X)

    clustered: Dict[str, List[str]] = {}
    for i, label in enumerate(est.labels_):
        clustered.setdefault(str(label), []).append(names[i])
    centers = {str(c): est.cluster_centers_[c].tolist() for c in range(len(est.cluster_centers_))}
    with open(os.path.join(params["out_dir"], "clusteredNouns.json"), "w") as f:
        json.dump(clustered, f)
    with open(os.path.join(params["out_dir"], "clusterCenters.json"), "w") as f:
        json.dump(centers, f)

    # human-readable summary (002_cluster_novel_words.py:105-121)
    with open(os.path.join(params["stats_dir"], "questionTypes.json")) as f:
        q_types = json.load(f)
    with open(os.path.join(params["stats_dir"], "filtStatsDict.json")) as f:
        filt = json.load(f)
    with open(os.path.join(params["out_dir"], "ClusterStatistics.txt"), "w") as f:
        for i in range(len(centers)):
            f.write("-" * 10 + f"\nCluster {i}\n" + "-" * 10 + "\n")
            center = centers[str(i)]
            top5 = sorted(range(len(center)), key=lambda j: center[j], reverse=True)[:5]
            f.write("Top 5 question types: " + "; ".join(q_types[j] for j in top5) + "\n")
            f.write(
                "Top 5 cluster scores: "
                + "; ".join("%.3f" % v for v in sorted(center, reverse=True)[:5])
                + "\n"
            )
            f.write("-" * 5 + "Nouns associated" + "-" * 5 + "\n")
            for noun in clustered.get(str(i), []):
                h = filt[noun]
                top5n = sorted(range(len(h)), key=lambda j: h[j], reverse=True)[:5]
                f.write(
                    "%-15s" % noun.replace("’", "")
                    + ": "
                    + "; ".join(q_types[j] for j in top5n)
                    + "\n"
                )
            f.write("\n")
    print(f"clustered {len(names)} nouns into {len(clustered)} clusters")


def run_split(params):
    random.seed(params["rng_seed"])
    with open(params["clusters"]) as f:
        cluster_nouns = json.load(f)

    train_nouns, test_nouns = set(), set()
    for i in cluster_nouns:
        random.shuffle(cluster_nouns[i])
        num_old = int(0.8 * len(cluster_nouns[i]))
        # off-by-one preserved: element num_old lands in NEITHER side (:36-42)
        for n in cluster_nouns[i][0:num_old]:
            train_nouns.add(n)
        for n in cluster_nouns[i][num_old + 1 :]:
            test_nouns.add(n)

    os.makedirs(params["save_base_path"], exist_ok=True)
    with open(os.path.join(params["save_base_path"], "trainNouns.json"), "w") as f:
        json.dump(sorted(train_nouns), f)
    with open(os.path.join(params["save_base_path"], "testNouns.json"), "w") as f:
        json.dump(sorted(test_nouns), f)

    def noun_set(question_text, answers):
        question = word_tokenize(question_text.lower().replace("/", " "))
        answer_set = set()
        for a in answers:
            for w in word_tokenize(a.lower().replace("/", " ")):
                answer_set.add(w)
        tagged = pos_tag(question, params["tagger"]) + pos_tag(
            list(answer_set), params["tagger"]
        )
        return [t[0] for t in tagged if t[1] == "NN"]

    with open(params["raw_train"]) as f:
        train_json = json.load(f)
    with open(params["raw_test"]) as f:
        val_json = json.load(f)
    with open(params["train_annotations"]) as f:
        train_anno = json.load(f)["annotations"]
    with open(params["val_annotations"]) as f:
        val_anno = json.load(f)["annotations"]
    with open(params["train_questions_mc"]) as f:
        train_q_mcq = json.load(f)
    with open(params["train_questions_oe"]) as f:
        train_q_oe = json.load(f)
    with open(params["val_questions_mc"]) as f:
        val_q_mcq = json.load(f)
    with open(params["val_questions_oe"]) as f:
        val_q_oe = json.load(f)

    def make_container(task_type, subtype):
        return {
            "info": [],
            "data_type": "mscoco_novel",
            "data_subtype": subtype,
            "license": [],
            "task_type": task_type,
            "questions": [],
        }

    train_kn, val_kn = [], []
    train_kn_anno = {"info": [], "data_type": "mscoco_novel", "data_subtype": "train", "annotations": []}
    val_kn_anno = {"info": [], "data_type": "mscoco_novel", "data_subtype": "test", "annotations": []}
    train_kn_mcq = make_container("Multiple-Choice", "train")
    val_kn_mcq = make_container("Multiple-Choice", "test")
    train_kn_oe = make_container("Open-Ended", "train")
    val_kn_oe = make_container("Open-Ended", "test")

    # train-origin items (:71-111)
    for el_count, el in enumerate(train_json):
        answers = [a["answer"] for a in train_anno[el_count]["answers"]]
        nouns = noun_set(el["question"], answers)
        is_test = any(n in test_nouns for n in nouns)
        if not is_test:
            train_kn.append(el)
            train_kn_anno["annotations"].append(train_anno[el_count])
            train_kn_mcq["questions"].append(train_q_mcq["questions"][el_count])
            train_kn_oe["questions"].append(train_q_oe["questions"][el_count])
        else:
            el.pop("ans", None)
            val_kn.append(el)
            val_kn_anno["annotations"].append(train_anno[el_count])
            val_kn_mcq["questions"].append(train_q_mcq["questions"][el_count])
            val_kn_oe["questions"].append(train_q_oe["questions"][el_count])

    # val-origin items: majority answer for train-bound (:113-178)
    el_count2 = 0
    for el in val_json:
        while val_anno[el_count2]["question_id"] != el["ques_id"]:
            el_count2 += 1
        el_anno = val_anno[el_count2]["answers"]
        counts: Dict[str, int] = {}
        for a in el_anno:
            counts[a["answer"]] = counts.get(a["answer"], 0) + 1
        max_count, final_ans = 0, None
        for ans in counts:  # first-max wins, like the reference loop (:136-140)
            if counts[ans] > max_count:
                max_count = counts[ans]
                final_ans = ans
        answers = [a["answer"] for a in el_anno]
        nouns = noun_set(el["question"], answers)
        is_test = any(n in test_nouns for n in nouns)
        if not is_test:
            el["ans"] = final_ans
            train_kn.append(el)
            train_kn_anno["annotations"].append(val_anno[el_count2])
            train_kn_mcq["questions"].append(val_q_mcq["questions"][el_count2])
            train_kn_oe["questions"].append(val_q_oe["questions"][el_count2])
        else:
            val_kn.append(el)
            val_kn_anno["annotations"].append(val_anno[el_count2])
            val_kn_mcq["questions"].append(val_q_mcq["questions"][el_count2])
            val_kn_oe["questions"].append(val_q_oe["questions"][el_count2])
        el_count2 += 1

    print("Size of training data: %d" % len(train_kn))
    print("Size of testing data: %d" % len(val_kn))

    for d in (
        params["save_base_path"],
        params["save_vqa_annotations_path"],
        params["save_vqa_questions_path"],
    ):
        os.makedirs(d, exist_ok=True)

    def dump(obj, d, name):
        with open(os.path.join(d, name), "w") as f:
            json.dump(obj, f)

    dump(train_kn, params["save_base_path"], "train_raw_novel_2.json")
    dump(val_kn, params["save_base_path"], "val_raw_novel_2.json")
    dump(train_kn_anno, params["save_vqa_annotations_path"], "mscoco_train2014_novel_2_annotations.json")
    dump(val_kn_anno, params["save_vqa_annotations_path"], "mscoco_val2014_novel_2_annotations.json")
    dump(train_kn_mcq, params["save_vqa_questions_path"], "MultipleChoice_mscoco_train2014_novel_2_questions.json")
    dump(train_kn_oe, params["save_vqa_questions_path"], "OpenEnded_mscoco_train2014_novel_2_questions.json")
    dump(val_kn_mcq, params["save_vqa_questions_path"], "MultipleChoice_mscoco_val2014_novel_2_questions.json")
    dump(val_kn_oe, params["save_vqa_questions_path"], "OpenEnded_mscoco_val2014_novel_2_questions.json")


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("stats")
    p.add_argument("--question_types", required=True)
    p.add_argument("--raw_train", required=True)
    p.add_argument("--raw_test", required=True)
    p.add_argument("--out_dir", default="Statistics/")
    p.add_argument("--min_count", default=10, type=int)
    p.add_argument("--tagger", default="auto", choices=["auto", "nltk", "heuristic"])

    p = sub.add_parser("cluster")
    p.add_argument("--stats_dir", default="Statistics/")
    p.add_argument("--out_dir", default="Clusters/")
    p.add_argument("--num_clusters", default=14, type=int)
    p.add_argument("--n_init", default=400, type=int)
    p.add_argument("--max_iter", default=5000, type=int)
    p.add_argument("--seed", default=123, type=int)

    p = sub.add_parser("split")
    p.add_argument("--clusters", default="Clusters/clusteredNouns.json")
    p.add_argument("--raw_train", required=True)
    p.add_argument("--raw_test", required=True)
    p.add_argument("--train_annotations", required=True)
    p.add_argument("--val_annotations", required=True)
    p.add_argument("--train_questions_mc", required=True)
    p.add_argument("--train_questions_oe", required=True)
    p.add_argument("--val_questions_mc", required=True)
    p.add_argument("--val_questions_oe", required=True)
    p.add_argument("--save_base_path", default="data/")
    p.add_argument("--save_vqa_annotations_path", default="Annotations/")
    p.add_argument("--save_vqa_questions_path", default="Questions/")
    p.add_argument("--rng_seed", default=123, type=int)
    p.add_argument("--tagger", default="auto", choices=["auto", "nltk", "heuristic"])

    args = parser.parse_args(argv)
    params = vars(args)
    if args.cmd == "stats":
        run_stats(params)
    elif args.cmd == "cluster":
        run_cluster(params)
    else:
        run_split(params)


if __name__ == "__main__":
    cli()
