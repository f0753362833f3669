from unimedvl_tpu_torch.eval.vqa import (
    build_transform,
    process_conversation,
    run_vqa_eval,
    exact_match_accuracy,
)
from unimedvl_tpu_torch.eval.text_metrics import (
    bleu,
    bleu3,
    meteor,
    rouge_l,
    report_metrics,
)

__all__ = [
    "build_transform",
    "process_conversation",
    "run_vqa_eval",
    "exact_match_accuracy",
    "bleu",
    "bleu3",
    "meteor",
    "rouge_l",
    "report_metrics",
]
