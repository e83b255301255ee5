"""Training-loop helpers shared by the device-resident drivers.

Ported so far: `structure_weight`, the per-structure loss weight of the
multitask schedule. Still to come with the checkpoint slice (ROADMAP Queue 1
item 6): the host loop `run_train`, `TrainResult`, `check_conv`
(convergence stopping), `resolve_queries` and the checkpointed
`run_train_device_mega` driver that uses them.
"""

from __future__ import annotations

from graphqembed_tpu_torch.config import GQEConfig


def structure_weight(cfg: GQEConfig, structure: str) -> float:
    """1p weighs 1; the other chains cfg.path_weight; structures with an
    intersection cfg.inter_weight."""
    if structure == "1p":
        return 1.0
    if structure in ("2p", "3p"):
        return cfg.path_weight
    return cfg.inter_weight
