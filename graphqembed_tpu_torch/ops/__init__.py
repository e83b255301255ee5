"""Custom gradients and the hand-written CUDA kernels with their plain versions."""


def _counted():
    from graphqembed_tpu_torch.ops import fused_adam, grads, kernels
    return fused_adam, grads, kernels


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    for m in _counted():
        m.reset_launch_counts()


def launch_counts() -> dict:
    """Launches of every kernel wrapper since the last reset_launch_counts()."""
    return {k: v for m in _counted() for k, v in m.LAUNCHES.items()}
