"""The eager PyTorch oracle: the GQE semantics (torch_gqe) and the training
protocol (train) in plain float64 torch on the CPU, the reference that the
port is held against."""

from graphqembed_tpu_torch.oracle import torch_gqe  # noqa: F401
