from densephrases_tpu_torch.eval.metrics import (
    normalize_answer,
    exact_match_score,
    f1_score,
    drqa_exact_match_score,
    drqa_regex_match_score,
    drqa_metric_max_over_ground_truths,
    metric_max_over_ground_truths,
)
