"""Training: the host loop and the device-resident drivers, checkpoints,
metrics, tracing and evaluation (AUC/APR)."""

from graphqembed_tpu_torch.training.eval import (  # noqa: F401
    auc_from_scores,
    eval_apr,
    eval_auc,
    percentile_ranks,
)
from graphqembed_tpu_torch.training.device_data import (  # noqa: F401
    DeviceTrainData,
    make_scan_train_step,
    make_scan_train_step_sparse,
    run_train_device,
)
from graphqembed_tpu_torch.training.metrics import (  # noqa: F401
    MetricsWriter,
    setup_logging,
)
from graphqembed_tpu_torch.training.sparse_adam import init_lazy_adam, lazy_adam_update  # noqa: F401
from graphqembed_tpu_torch.training.loop import (  # noqa: F401
    TrainData,
    TrainResult,
    check_conv,
    make_train_step,
    run_train,
)
