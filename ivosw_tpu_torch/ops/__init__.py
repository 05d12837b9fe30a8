from ivosw_tpu_torch.ops.metrics import (
    auc_from_curve,
    batched_f_measure,
    batched_jaccard,
    sequence_metric,
)

__all__ = [
    "auc_from_curve",
    "batched_f_measure",
    "batched_jaccard",
    "sequence_metric",
]
