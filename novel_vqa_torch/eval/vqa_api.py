"""VQA dataset interface (copy of ``novel_vqa_tpu.eval.vqa_api``) — Python-3
port of the reference's VQA-api fork
(004_vqa_evaluation/PythonHelperTools/vqaTools/vqa.py), behavior-preserving:

  * index annotations by question id and image id (vqa.py:47-63);
  * filtered id getters (vqa.py:73-119);
  * ``loadRes`` builds a result-VQA object, asserting the result question-id
    set equals the annotation set and (for Multiple Choice) that each answer
    is among the provided choices (vqa.py:146-182) — these asserts are the
    reference's only integration checks and are kept as hard errors.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional


class VQA:
    def __init__(
        self,
        annotation_file: Optional[str] = None,
        question_file: Optional[str] = None,
    ):
        self.dataset: Dict[str, Any] = {}
        self.questions: Dict[str, Any] = {}
        self.qa: Dict[int, Any] = {}
        self.qqa: Dict[int, Any] = {}
        self.imgToQA: Dict[int, List[Any]] = {}
        if annotation_file is not None and question_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            with open(question_file) as f:
                self.questions = json.load(f)
            self.createIndex()

    def createIndex(self):
        imgToQA: Dict[int, List[Any]] = {
            ann["image_id"]: [] for ann in self.dataset["annotations"]
        }
        qa: Dict[int, Any] = {ann["question_id"]: [] for ann in self.dataset["annotations"]}
        qqa: Dict[int, Any] = {ann["question_id"]: [] for ann in self.dataset["annotations"]}
        for ann in self.dataset["annotations"]:
            imgToQA[ann["image_id"]].append(ann)
            qa[ann["question_id"]] = ann
        for ques in self.questions["questions"]:
            qqa[ques["question_id"]] = ques
        self.qa = qa
        self.qqa = qqa
        self.imgToQA = imgToQA

    def getQuesIds(self, imgIds=[], quesTypes=[], ansTypes=[]) -> List[int]:
        imgIds = imgIds if isinstance(imgIds, list) else [imgIds]
        quesTypes = quesTypes if isinstance(quesTypes, list) else [quesTypes]
        ansTypes = ansTypes if isinstance(ansTypes, list) else [ansTypes]
        if len(imgIds) == len(quesTypes) == len(ansTypes) == 0:
            anns = self.dataset["annotations"]
        else:
            if imgIds:
                anns = sum(
                    (self.imgToQA[i] for i in imgIds if i in self.imgToQA), []
                )
            else:
                anns = self.dataset["annotations"]
            if quesTypes:
                anns = [a for a in anns if a["question_type"] in quesTypes]
            if ansTypes:
                anns = [a for a in anns if a["answer_type"] in ansTypes]
        return [ann["question_id"] for ann in anns]

    def getImgIds(self, quesIds=[], quesTypes=[], ansTypes=[]) -> List[int]:
        quesIds = quesIds if isinstance(quesIds, list) else [quesIds]
        quesTypes = quesTypes if isinstance(quesTypes, list) else [quesTypes]
        ansTypes = ansTypes if isinstance(ansTypes, list) else [ansTypes]
        if len(quesIds) == len(quesTypes) == len(ansTypes) == 0:
            anns = self.dataset["annotations"]
        else:
            if quesIds:
                # reference sums annotation dicts into a list (vqa.py:113);
                # each self.qa[qid] is a single ann dict there, so collect them
                anns = [self.qa[q] for q in quesIds if q in self.qa]
            else:
                anns = self.dataset["annotations"]
            if quesTypes:
                anns = [a for a in anns if a["question_type"] in quesTypes]
            if ansTypes:
                anns = [a for a in anns if a["answer_type"] in ansTypes]
        return [ann["image_id"] for ann in anns]

    def loadQA(self, ids=[]) -> List[Any]:
        if isinstance(ids, list):
            return [self.qa[i] for i in ids]
        return [self.qa[ids]]

    def loadRes(self, resFile: str, quesFile: str) -> "VQA":
        res = VQA()
        with open(quesFile) as f:
            res.questions = json.load(f)
        for key in ("info", "task_type", "data_type", "data_subtype", "license"):
            res.dataset[key] = copy.deepcopy(self.questions[key])

        with open(resFile) as f:
            anns = json.load(f)
        assert isinstance(anns, list), "results is not an array of objects"
        annsQuesIds = [ann["question_id"] for ann in anns]
        assert set(annsQuesIds) == set(self.getQuesIds()), (
            "Results do not correspond to current VQA set. Either the results "
            "do not have predictions for all question ids in annotation file "
            "or there is atleast one question id that does not belong to the "
            "question ids in the annotation file."
        )
        for ann in anns:
            quesId = ann["question_id"]
            if res.dataset["task_type"] == "Multiple Choice":
                assert (
                    ann["answer"] in self.qqa[quesId]["multiple_choices"]
                ), "predicted answer is not one of the multiple choices"
            qaAnn = self.qa[quesId]
            ann["image_id"] = qaAnn["image_id"]
            ann["question_type"] = qaAnn["question_type"]
            ann["answer_type"] = qaAnn["answer_type"]

        res.dataset["annotations"] = anns
        res.createIndex()
        return res
