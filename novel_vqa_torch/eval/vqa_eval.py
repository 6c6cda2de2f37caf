"""Official VQA accuracy (copy of ``novel_vqa_tpu.eval.vqa_eval``) — bit-exact
Python-3 port of
004_vqa_evaluation/PythonEvaluationTools/vqaEvaluation/vqaEval.py.

The metric: per question, answer-string normalization (punctuation strip
:131-141, digit/article/contraction mapping :143-156) followed by
``min(1, #matching_gt/3)`` averaged leave-one-out over the 10 human answers
(:99-103), bucketed per question type and answer type (:158-167).

Bit-exactness notes (parity gate is 0.3%, SURVEY.md section 7):
  * the contraction table mixes ASCII and typographic (U+2019) apostrophes —
    it is loaded verbatim from ``normalization_tables.json``, machine-extracted
    from the reference source;
  * the period-strip regex ``(?!<=\\d)(\\.)(?!\\d)`` is reproduced verbatim,
    including its (inert) malformed lookbehind;
  * the reference passes ``re.UNICODE`` as the *count* positional of
    ``re.sub`` (:138-140), capping period removal at 32 occurrences —
    reproduced via ``count=32``;
  * ground-truth answers are punctuation-processed *in place* when a question
    has more than one distinct answer (:96-98), so a second ``evaluate`` call
    (the novel-subset pass, evaluate_openended_novel.py:47) sees the already
    normalized answers — the mutation is preserved.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

_TABLES_PATH = os.path.join(os.path.dirname(__file__), "normalization_tables.json")


class VQAEval:
    def __init__(self, vqa=None, vqaRes=None, n: int = 2):
        self.n = n
        self.accuracy: Dict = {}
        self.evalQA: Dict = {}
        self.evalQuesType: Dict = {}
        self.evalAnsType: Dict = {}
        self.vqa = vqa
        self.vqaRes = vqaRes
        if vqa is not None:
            self.params = {"question_id": vqa.getQuesIds()}
        with open(_TABLES_PATH) as f:
            tables = json.load(f)
        self.contractions: Dict[str, str] = tables["contractions"]
        self.manualMap: Dict[str, str] = tables["manualMap"]
        self.articles: List[str] = tables["articles"]
        self.punct: List[str] = tables["punct"]
        self.periodStrip = re.compile(r"(?!<=\d)(\.)(?!\d)")
        self.commaStrip = re.compile(r"(\d)(\,)(\d)")

    def evaluate(self, quesIds: Optional[List[int]] = None):
        if quesIds is None:
            quesIds = list(self.params["question_id"])
        gts = {quesId: self.vqa.qa[quesId] for quesId in quesIds}
        res = {quesId: self.vqaRes.qa[quesId] for quesId in quesIds}

        accQA = []
        accQuesType: Dict[str, List[float]] = {}
        accAnsType: Dict[str, List[float]] = {}
        for quesId in quesIds:
            resAns = res[quesId]["answer"]
            resAns = resAns.replace("\n", " ").replace("\t", " ").strip()
            resAns = self.processPunctuation(resAns)
            resAns = self.processDigitArticle(resAns)
            gtAnswers = [ans["answer"] for ans in gts[quesId]["answers"]]
            if len(set(gtAnswers)) > 1:
                for ansDic in gts[quesId]["answers"]:
                    ansDic["answer"] = self.processPunctuation(ansDic["answer"])
            gtAcc = []
            for gtAnsDatum in gts[quesId]["answers"]:
                # dict inequality, as in the reference (vqaEval.py:100) — with
                # unique answer_ids this equals identity, but keep it exact
                otherGTAns = [
                    item for item in gts[quesId]["answers"] if item != gtAnsDatum
                ]
                matchingAns = [
                    item for item in otherGTAns if item["answer"] == resAns
                ]
                gtAcc.append(min(1.0, float(len(matchingAns)) / 3))
            quesType = gts[quesId]["question_type"]
            ansType = gts[quesId]["answer_type"]
            avgGTAcc = float(sum(gtAcc)) / len(gtAcc)
            accQA.append(avgGTAcc)
            accQuesType.setdefault(quesType, []).append(avgGTAcc)
            accAnsType.setdefault(ansType, []).append(avgGTAcc)
            self.setEvalQA(quesId, avgGTAcc)
            self.setEvalQuesType(quesId, quesType, avgGTAcc)
            self.setEvalAnsType(quesId, ansType, avgGTAcc)

        self.setAccuracy(accQA, accQuesType, accAnsType)

    def processPunctuation(self, inText: str) -> str:
        outText = inText
        for p in self.punct:
            if (p + " " in inText or " " + p in inText) or (
                re.search(self.commaStrip, inText) is not None
            ):
                outText = outText.replace(p, "")
            else:
                outText = outText.replace(p, " ")
        # the reference passes re.UNICODE (==32) as re.sub's *count* argument
        # (vqaEval.py:138-140): at most 32 periods are stripped
        outText = self.periodStrip.sub("", outText, count=32)
        return outText

    def processDigitArticle(self, inText: str) -> str:
        outText = []
        tempText = inText.lower().split()
        for word in tempText:
            word = self.manualMap.get(word, word)
            if word not in self.articles:
                outText.append(word)
        for wordId, word in enumerate(outText):
            if word in self.contractions:
                outText[wordId] = self.contractions[word]
        return " ".join(outText)

    def setAccuracy(self, accQA, accQuesType, accAnsType):
        self.accuracy["overall"] = round(100 * float(sum(accQA)) / len(accQA), self.n)
        self.accuracy["perQuestionType"] = {
            qt: round(100 * float(sum(v)) / len(v), self.n)
            for qt, v in accQuesType.items()
        }
        self.accuracy["perAnswerType"] = {
            at: round(100 * float(sum(v)) / len(v), self.n)
            for at, v in accAnsType.items()
        }

    def setEvalQA(self, quesId, acc):
        self.evalQA[quesId] = round(100 * acc, self.n)

    def setEvalQuesType(self, quesId, quesType, acc):
        self.evalQuesType.setdefault(quesType, {})[quesId] = round(100 * acc, self.n)

    def setEvalAnsType(self, quesId, ansType, acc):
        self.evalAnsType.setdefault(ansType, {})[quesId] = round(100 * acc, self.n)
