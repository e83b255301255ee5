"""graphqembed_tpu_torch — GQE (arXiv:1806.01445) in PyTorch, with the JAX
package's TPU kernels rewritten by hand in CUDA C++ for NVIDIA Hopper.

It mirrors the module paths of `graphqembed_tpu`, which stays the reference,
and imports nothing of it:
  graph/     typed multigraph, synthetic generators, edge holdout
  data/      query formalism, per-formula batches, the host-side sampler,
             graph pickle and query-set IO
  models/    parameter trees; the GQE model on per-formula batches and on
             mixed-formula rows (the one-gather train loss)
  ops/       custom gradients; the fused-Adam, gather, scoring and
             intersection CUDA kernels with their plain PyTorch versions
             (csrc/ holds the sources)
  training/  the host loop and the device-resident drivers, checkpoints,
             metrics, tracing, eval (AUC/APR)
  cli/       gqe-torch-train and gqe-torch-eval
  experiments/  the kernel bench on the card

Entry points run on the card unless the caller passes device="cpu"; on the
CPU every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"

from graphqembed_tpu_torch.config import GQEConfig  # noqa: F401
