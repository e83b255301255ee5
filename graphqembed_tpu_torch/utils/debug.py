"""Debug-run validation, the JAX package's `utils/debug.py`. A gather with
an id out of range either raises (PyTorch on the CPU), ends the CUDA
context with a device-side assert (on the card) or, in XLA, clamps
silently; a NaN or Inf spreads through every later step. So a debug run
checks the ids on the host before they reach a gather, and the loss after
it: `checked_margin_loss` is the counterpart of JAX's checkify wrapper
(float and index checks).
"""

from __future__ import annotations

import numpy as np
import torch

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.models import gqe


def validate_ids(ids, n_rows: int, name: str = "ids") -> None:
    """Host-side check that every id lies in [0, n_rows): ValueError
    otherwise. ids: a numpy array, a sequence or a tensor (read back to
    the host)."""
    a = ids.detach().cpu().numpy() if isinstance(ids, torch.Tensor) \
        else np.asarray(ids)
    if a.size == 0:
        return
    if a.min() < 0 or a.max() >= n_rows:
        raise ValueError(
            f"{name}: out-of-range node id (min={a.min()}, max={a.max()}, "
            f"table rows={n_rows}): a gather would fail or read the wrong "
            "row")


def checked_margin_loss(cfg: GQEConfig):
    """The per-formula margin loss (models/gqe.py::margin_loss) with debug
    checks: run(params, structure, anchors, rels, inter_mode_id, targets,
    negs, row_mask) validates anchors, targets and negatives against the
    table's rows before anything is gathered (ValueError), and raises
    FloatingPointError when the loss is not finite. Arrays may be numpy or
    tensors; they are moved to the parameters' device. Reading the loss
    back waits for the device: for debug runs and tests."""

    def run(params, structure, anchors, rels, inter_mode_id, targets, negs,
            row_mask):
        table = params["table"]
        for name, ids in (("anchors", anchors), ("targets", targets),
                          ("negs", negs)):
            validate_ids(ids, table.shape[0], name)

        def on(x, dtype=torch.int64):
            return torch.as_tensor(x).to(device=table.device, dtype=dtype)

        loss = gqe.margin_loss(cfg, params, structure, on(anchors),
                               [int(r) for r in rels], int(inter_mode_id),
                               on(targets), on(negs), on(row_mask, torch.bool))
        if not bool(torch.isfinite(loss)):
            raise FloatingPointError(
                f"margin loss is not finite: {float(loss.detach())}")
        return loss

    return run
