"""Device-resident training pipeline and evaluation (AUC/APR)."""

from graphqembed_tpu_torch.training.eval import eval_apr, eval_auc  # noqa: F401
