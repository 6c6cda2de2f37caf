from novel_vqa_torch.eval.vqa_api import VQA
from novel_vqa_torch.eval.vqa_eval import VQAEval
