"""Real-dimension rehearsal: the flagship pipeline at novel_v2 scale on
synthetic data (port of ``novel_vqa_tpu.utils.rehearsal``).

The end-to-end tests run at miniature dimensions; the real run's unknowns
(the ~1.9 GB device-resident fc7 store, the upload, eval and the official
VQAEval at 100k+ questions) show only at the real shapes.  This tool
generates a synthetic dataset at the REAL novel_v2 dimensions (SURVEY.md
section 6 scale anchors; ``--vocab_dir`` supplies the vocabularies, the
reference's frozen ``vocab_train.json`` (12,782 words) and
``oracle_extern_ans_vocab.json`` (1,000 answers)) and drives the port's
CLIs through it on the card, reporting wall time per stage, the
150k-iteration projection (002_train_baseline.lua:31-32) and device
memory:

  * raw VQA JSONs: ~215k train / ~121k test questions over ~120k / ~40.5k
    unique images (VQA v1 train2014/val2014 counts), question text sampled
    from the train vocabulary, answers from the answer vocabulary (the
    bytes are the JAX tool's for the same arguments);
  * ``pipeline.prepro_vqa`` with the extern vocabularies (the published
    flow, --extern_vocab/--extern_ans_vocab);
  * a float32 fc7 store at real shape ((~120k, 4096) ~ 1.9 GB, through the
    port's ``core/h5.py``; the card's machine has no h5py): synthetic
    features stand in for the extraction output; an optional short REAL
    extraction segment (VGG-16 fc7 at 224, fixed synthetic weights, a
    synthetic JPEG corpus) measures images/s to project the full pass;
  * ``train.train_vqa_arch1`` for --iters iterations on the resident
    multi-step route (batch 500, 2x512, the reference workload);
  * ``train.eval_vqa_arch1`` over the full test split;
  * ``eval.drivers`` (VQAEval) incl. a 32,452-qid novel subset
    (ques_id_hist bucket '0', evaluate_openended_novel.py:38,47).

Accuracy numbers are meaningless (random features and answers); the
rehearsal validates CAPACITY and measures TIME.  Reduce --scale for smoke
tests (scale 1.0 = full novel_v2 dimensions).  The report's keys are the
JAX tool's, plus ``launches`` (the kernels' launches per stage) and the
device memory from ``torch.cuda``.

    python -m novel_vqa_torch.utils.rehearsal --vocab_dir vocabs/ --scale 0.05
    python -m novel_vqa_torch.utils.rehearsal ... --device cpu --extract_images 0
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def _log(*a):
    print("[rehearsal]", *a, file=sys.stderr, flush=True)


def gen_raw(out_dir, n_train_q, n_test_q, n_train_img, n_test_img,
            words, answers, seed=123):
    rs = np.random.RandomState(seed)
    widx = rs.randint(0, len(words), size=(n_train_q + n_test_q, 10))
    qlens = rs.randint(3, 11, size=n_train_q + n_test_q)
    aidx = rs.randint(0, len(answers), size=n_train_q + n_test_q)

    def rows(n, qid0, img_fmt, n_img, off, test=False):
        out = []
        for i in range(n):
            j = off + i
            q = " ".join(words[w] for w in widx[j, : qlens[j]]) + "?"
            rec = {
                "ques_id": qid0 + i,
                "img_path": img_fmt % (i % n_img),
                "question": q,
                "ans": answers[aidx[j]],
            }
            if test:
                mc = {answers[aidx[j]]}
                while len(mc) < 18:
                    mc.add(answers[rs.randint(0, len(answers))])
                rec["MC_ans"] = sorted(mc)
            out.append(rec)
        return out

    train = rows(n_train_q, 1, "train2014/COCO_train2014_%012d.jpg", n_train_img, 0)
    test = rows(n_test_q, 1_000_000, "val2014/COCO_val2014_%012d.jpg",
                n_test_img, n_train_q, test=True)
    with open(os.path.join(out_dir, "raw_train.json"), "w") as f:
        json.dump(train, f)
    with open(os.path.join(out_dir, "raw_test.json"), "w") as f:
        json.dump(test, f)
    return [r["ques_id"] for r in test], test


def gen_fc7(out_path, meta_json, ndims=4096, seed=7):
    """Synthetic fc7 store shaped by data_prepro.json's unique_img_* lists,
    the layout extract_features writes (001_prepro_img_vgg.lua:156-160); the
    arrays are the JAX tool's (the same draws, in the same chunks)."""
    from novel_vqa_torch.core.h5 import write_h5

    with open(meta_json) as f:
        meta = json.load(f)
    rs = np.random.RandomState(seed)
    sizes, stores = {}, {}
    for split in ("train", "val", "test"):
        n = len(meta.get(f"unique_img_{split}", []))
        if not n:
            continue
        d = np.empty((n, ndims), np.float32)
        chunk = 8192
        for i in range(0, n, chunk):
            m = min(chunk, n - i)
            d[i : i + m] = rs.randn(m, ndims).astype(np.float32)
        stores[f"images_{split}"] = d
        sizes[split] = n
    write_h5(out_path, stores)
    return sizes


def device_memory_stats(device: torch.device) -> dict:
    """The card's allocator counters (bytes), the peak since the last
    reset among them; the CPU has none."""
    if device.type != "cuda":
        return {"unavailable": "no card (a CPU run)"}
    free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_reserved": torch.cuda.memory_reserved(device),
        "bytes_free": free,
        "bytes_limit": total,
    }


def make_jpeg_corpus(root: str, n_files: int, w: int = 640, h: int = 480):
    """A small synthetic JPEG corpus (photo-like smooth noise, so decode
    cost is realistic): a path list of ``n_files`` entries cycling over at
    most 16 distinct files (the JAX bench's corpus, bench.py:739)."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    distinct = min(n_files, 16)
    rs = np.random.RandomState(7)
    paths = []
    for i in range(distinct):
        p = os.path.join(root, f"img_{i:03d}.jpg")
        if not os.path.exists(p):
            base = rs.rand(h // 8, w // 8, 3)
            img = np.kron(base, np.ones((8, 8, 1)))  # smooth blocks
            img += rs.rand(h, w, 3) * 0.1
            Image.fromarray((img * 255 / img.max()).astype(np.uint8)).save(p, quality=90)
        paths.append(p)
    return [paths[i % distinct] for i in range(n_files)]


def fixed_synthetic_vgg16_weights(path: str) -> str:
    """Write (once) a deterministic synthetic VGG-16 npz (seed 123, the
    layout both packages read) and return its path, so the extraction
    segment loads FIXED weights through the real ``--weights`` path."""
    if not os.path.exists(path):
        from novel_vqa_torch.core.checkpoint import save_npz
        from novel_vqa_torch.core.convert import vision_params_to_numpy
        from novel_vqa_torch.models.vision import vgg

        params = vgg.init_params(vgg.VGGConfig(arch="vgg16", image_size=224),
                                 torch.Generator().manual_seed(123), "cpu")
        save_npz(path, vision_params_to_numpy(params))
    return path


def _launches():
    from novel_vqa_torch.kernels import lstm as K
    from novel_vqa_torch.kernels import lstm2 as K2

    return {"lstm_seq": K.lstm_seq.launches, "lstm_step": K.lstm_step.launches,
            "lstm_seq2": K2.lstm_seq2.launches}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work_dir", default=os.path.join(tempfile.gettempdir(), "nvqa_rehearsal"))
    ap.add_argument("--scale", type=float, default=1.0,
                    help="dimension multiplier (1.0 = full novel_v2 scale)")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--steps_per_dispatch", type=int, default=250)
    ap.add_argument("--batch_size", type=int, default=500)
    ap.add_argument("--extract_images", type=int, default=640,
                    help="REAL 224^2 extraction segment length (0 = skip)")
    ap.add_argument("--vocab_dir", default="vocabs",
                    help="holds vocab_train.json and oracle_extern_ans_vocab.json")
    ap.add_argument("--report", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from novel_vqa_torch.core.device import resolve_device

    device = resolve_device(args.device)
    # resolve caller-relative paths against the INVOCATION cwd before
    # chdir'ing into the work dir, so they land where the caller expects
    if args.report:
        args.report = os.path.abspath(args.report)
    args.vocab_dir = os.path.abspath(args.vocab_dir)
    os.makedirs(args.work_dir, exist_ok=True)
    os.chdir(args.work_dir)
    report = {"scale": args.scale, "dims": {}, "wall_s": {}, "memory": {}, "launches": {},
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    t_all = time.perf_counter()

    # ---- dimensions (SURVEY.md section 6 anchors at scale 1.0) ------------
    n_train_q = int(215_000 * args.scale)
    n_test_q = int(121_512 * args.scale)
    n_train_img = int(120_000 * args.scale)
    n_test_img = int(40_504 * args.scale)
    n_novel = min(32_452, n_test_q)
    report["dims"] = {
        "train_questions": n_train_q, "test_questions": n_test_q,
        "train_images": n_train_img, "test_images": n_test_img,
        "novel_subset": n_novel,
    }

    with open(os.path.join(args.vocab_dir, "vocab_train.json")) as f:
        words = json.load(f)
    with open(os.path.join(args.vocab_dir, "oracle_extern_ans_vocab.json")) as f:
        answers = json.load(f)
    _log(f"vocab {len(words)} words, {len(answers)} answers")

    # ---- stage: raw JSON generation --------------------------------------
    t0 = time.perf_counter()
    test_qids, test_rows = gen_raw(
        ".", n_train_q, n_test_q, n_train_img, n_test_img, words, answers
    )
    report["wall_s"]["gen_raw"] = round(time.perf_counter() - t0, 1)
    _log("raw JSONs written", report["wall_s"]["gen_raw"], "s")

    # ---- stage: prepro_vqa (real tokenize/encode volume) ------------------
    from novel_vqa_torch.pipeline import prepro_vqa

    t0 = time.perf_counter()
    prepro_vqa.cli([
        "--input_train_json", "raw_train.json",
        "--input_test_json", "raw_test.json",
        "--num_ans", str(len(answers)),
        "--extern_vocab", os.path.join(args.vocab_dir, "vocab_train.json"),
        "--extern_ans_vocab", os.path.join(args.vocab_dir, "oracle_extern_ans_vocab.json"),
        "--num_val", str(max(1000, int(2000 * args.scale))),
        "--max_length", "16",
    ])
    report["wall_s"]["prepro_vqa"] = round(time.perf_counter() - t0, 1)
    _log("prepro_vqa done", report["wall_s"]["prepro_vqa"], "s")

    # ---- stage: fc7 store at real shape ----------------------------------
    t0 = time.perf_counter()
    sizes = gen_fc7("data_img.h5", "data_prepro.json")
    report["wall_s"]["gen_fc7_store"] = round(time.perf_counter() - t0, 1)
    report["dims"]["fc7_store"] = sizes
    report["dims"]["fc7_train_gb"] = round(sizes.get("train", 0) * 4096 * 4 / 2**30, 2)
    _log("fc7 store written", sizes, report["wall_s"]["gen_fc7_store"], "s")

    # ---- stage: optional REAL extraction segment (224^2 VGG-16) ----------
    if args.extract_images:
        from novel_vqa_torch.train.extract_features import build_model, run_pipelined_extraction

        paths = make_jpeg_corpus(os.path.abspath("jpegs"), args.extract_images)
        t0 = time.perf_counter()
        model = build_model("vgg16", fixed_synthetic_vgg16_weights(os.path.abspath("vgg16.npz")),
                            "fc7", 123, device=device)
        u8 = torch.zeros((32, 224, 224, 3), dtype=torch.uint8, device=device)
        model[0](u8, torch.zeros(32, dtype=torch.bool, device=device)).cpu()
        report["wall_s"]["extract_compile"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        run_pipelined_extraction([model], paths, 32, 8)
        wall = time.perf_counter() - t0
        rate = args.extract_images / wall
        report["wall_s"]["extract_segment"] = round(wall, 1)
        report["extraction"] = {
            "segment_images": args.extract_images,
            "images_per_sec": round(rate, 1),
            "full_train_store_projection_min": round(n_train_img / rate / 60, 1),
        }
        _log("extraction segment", report["extraction"])

    # ---- stage: arch1 training (the resident multi-step route) ------------
    from novel_vqa_torch.core.h5 import H5Reader
    from novel_vqa_torch.train import train_vqa_arch1

    # analytic device budget for the resident working set: fc7 store +
    # token/label arrays + params, grads, and rmsprop state (~3x params)
    with open("data_prepro.json") as f:
        _meta = json.load(f)
    n_tr_img = len(_meta.get("unique_img_train", []))
    with H5Reader("data_prepro.h5") as f:
        n_tr_q = f.dataset("ques_train").shape[0]
    params_mb = 15e6 * 4 / 2**20  # ~15M-param model (SURVEY 2.8)
    report["memory"]["analytic_resident_mb"] = {
        "fc7_store": round(n_tr_img * 4096 * 4 / 2**20, 1),
        "tokens_ids_answers": round(n_tr_q * (16 + 2) * 4 / 2**20, 1),
        "params_plus_opt_state": round(3 * params_mb, 1),
        "total_gb": round(
            (n_tr_img * 4096 * 4 + n_tr_q * 18 * 4 + 3 * params_mb * 2**20) / 2**30, 2,
        ),
    }
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    report["memory"]["before_train"] = device_memory_stats(device)
    before = _launches()
    t0 = time.perf_counter()
    train_vqa_arch1.main([
        "--input_img_h5", "data_img.h5",
        "--input_ques_h5", "data_prepro.h5",
        "--input_json", "data_prepro.json",
        "--checkpoint_path", "model/",
        "--batch_size", str(args.batch_size),
        "--max_iters", str(args.iters),
        "--save_checkpoint_every", str(args.iters),
        "--steps_per_dispatch", str(args.steps_per_dispatch),
        "--log_every", str(args.steps_per_dispatch),
        "--device", str(device),
    ])
    _sync(device)
    train_wall = time.perf_counter() - t0
    report["launches"]["train"] = _since(before)
    report["wall_s"]["train_1k_iters"] = round(train_wall, 1)
    report["memory"]["after_train"] = device_memory_stats(device)
    # total/iters is the conservative figure (set-up and the store's upload
    # included)
    report["train"] = {
        "iters": args.iters,
        "wall_ms_per_iter_incl_setup": round(1000 * train_wall / args.iters, 2),
        "projection_150k_iters_hours_incl_setup": round(
            train_wall / args.iters * 150_000 / 3600, 2
        ),
    }
    _log("train done", report["train"])

    # ---- stage: eval over the full test split -----------------------------
    from novel_vqa_torch.train import eval_vqa_arch1

    before = _launches()
    t0 = time.perf_counter()
    eval_vqa_arch1.main([
        "--input_img_h5", "data_img.h5",
        "--input_ques_h5", "data_prepro.h5",
        "--input_json", "data_prepro.json",
        "--model_path", "model/lstm.h5",
        "--batch_size", str(args.batch_size),
        "--out_path", "result/",
        "--device", str(device),
    ])
    report["wall_s"]["eval_full_split"] = round(time.perf_counter() - t0, 1)
    report["launches"]["eval"] = _since(before)
    report["memory"]["after_eval"] = device_memory_stats(device)
    _log("eval done", report["wall_s"]["eval_full_split"], "s")

    # ---- stage: official VQAEval incl. novel subset -----------------------
    rs = np.random.RandomState(3)
    novel_qids = [int(q) for q in rs.choice(test_qids, size=n_novel, replace=False)]
    with open("ques_id_hist.json", "w") as f:
        json.dump({"0": novel_qids}, f)
    ann = {
        "info": {}, "data_type": "mscoco", "data_subtype": "val2014",
        "license": {},
        "annotations": [
            {
                "question_id": r["ques_id"],
                "image_id": int(r["img_path"][-16:-4]),
                "question_type": "what is", "answer_type": "other",
                "multiple_choice_answer": r["ans"],
                "answers": [
                    {"answer": r["ans"], "answer_confidence": "yes",
                     "answer_id": j + 1}
                    for j in range(10)
                ],
            }
            for r in test_rows
        ],
    }
    ques = {
        "info": {}, "task_type": "Open-Ended", "data_type": "mscoco",
        "data_subtype": "val2014", "license": {},
        "questions": [
            {"question_id": r["ques_id"], "image_id": int(r["img_path"][-16:-4]),
             "question": r["question"]}
            for r in test_rows
        ],
    }
    with open("ann.json", "w") as f:
        json.dump(ann, f)
    with open("ques.json", "w") as f:
        json.dump(ques, f)

    from novel_vqa_torch.eval.drivers import evaluate

    t0 = time.perf_counter()
    acc = evaluate(
        "ann.json", "ques.json",
        "result/OpenEnded_mscoco_val2014_lstm_novel_new_2_results.json",
        ques_id_hist="ques_id_hist.json",
    )
    report["wall_s"]["vqa_eval"] = round(time.perf_counter() - t0, 1)
    report["accuracy_sanity"] = {
        "overall": acc["overall"], "novel": acc.get("novel"),
        "note": "random features/answers -> near-chance by construction",
    }
    _log("VQAEval done", report["wall_s"]["vqa_eval"], "s", acc["overall"])

    report["wall_s"]["total"] = round(time.perf_counter() - t_all, 1)
    out = json.dumps(report)
    print(out)
    if args.report:
        with open(args.report, "w") as f:
            f.write(out)
    return report


if __name__ == "__main__":
    main()
