"""Checkpoint / resume: full train-state checkpoints (parameters, optimizer
state, step, host RNG state), a light "best eval" export, and a host copy of
the parameters in the shared layout. The JAX package writes the same
layout with orbax; here the tensors go through `torch.save`.

A step directory `<root>/step_00000123/` holds `state.pt` (the tensors,
dtypes kept: a bfloat16 table comes back as bfloat16) and `meta.json` (the
step and any plain-JSON resume state). It is written under a temporary
name and moved into place with `os.replace`, so a process killed mid-write
leaves no half-written step directory; a directory without `meta.json` is
never restored.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.models.params import params_to_numpy


def _write(path: Path, state: dict, meta: dict) -> None:
    path = Path(path).absolute()
    tmp = path.with_name(f".{path.name}.tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save(state, tmp / "state.pt")
    (tmp / "meta.json").write_text(json.dumps(meta))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def save_checkpoint(path: str | Path, params: dict, step: int,
                    opt_state=None, extra: dict | None = None) -> None:
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    _write(Path(path), state, {"step": step, **(extra or {})})


def load_checkpoint(path: str | Path, device=None):
    """Returns (state dict, meta), the tensors on `device` (None means the
    card, as for every entry point; pass "cpu" for the CPU)."""
    path = Path(path).absolute()
    state = torch.load(path / "state.pt", weights_only=True,
                       map_location=resolve_device(device))
    meta = json.loads((path / "meta.json").read_text())
    return state, meta


def latest_step_dir(root: str | Path) -> Path | None:
    """The newest complete step directory <root>/step_000123 (one with a
    meta.json), or None."""
    root = Path(root)
    if not root.exists():
        return None
    dirs = sorted(d for d in root.iterdir()
                  if d.name.startswith("step_") and (d / "meta.json").exists())
    return dirs[-1] if dirs else None


class CheckpointManager:
    """Periodic train-state checkpoints with restart from the latest: keeps
    the newest `keep` step directories."""

    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.keep = keep
        self.root.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, params: dict, opt_state, rng_state=None,
             extra: dict | None = None) -> None:
        """The host loop's checkpoint: params, optimizer state and, as JSON
        in meta.json, the numpy batch sampler's RNG state and `extra`."""
        meta = dict(extra or {})
        if rng_state is not None:
            meta["rng_state"] = _rng_state_to_json(rng_state)
        save_checkpoint(self.root / f"step_{step:08d}", params, step,
                        opt_state=opt_state, extra=meta)
        self._prune()

    def save_state(self, step: int, state: dict,
                   extra: dict | None = None) -> None:
        """Any state tree (the device driver saves {params, opt_state,
        best_params}; its resume counters are plain JSON in `extra`: batch
        selection there is counter-based, so no host RNG state exists)."""
        _write(self.root / f"step_{step:08d}", state,
               {"step": step, **(extra or {})})
        self._prune()

    def _prune(self) -> None:
        dirs = sorted(d for d in self.root.iterdir()
                      if d.name.startswith("step_"))
        for d in dirs[:-self.keep]:
            shutil.rmtree(d)

    def restore_latest(self, device=None):
        """(state, meta) of the newest complete step directory, or None.
        meta["rng_state"], where saved, comes back as a numpy Generator."""
        d = latest_step_dir(self.root)
        if d is None:
            return None
        state, meta = load_checkpoint(d, device)
        if "rng_state" in meta:
            meta["rng_state"] = _rng_state_from_json(meta["rng_state"])
        return state, meta


def _rng_state_to_json(rng: np.random.Generator) -> dict:
    st = rng.bit_generator.state
    return json.loads(json.dumps(st, default=int))


def _rng_state_from_json(st: dict) -> np.random.Generator:
    rng = np.random.default_rng(0)
    rng.bit_generator.state = st
    return rng


def export_for_oracle(params: dict) -> dict:
    """Host numpy copy of params in the shared layout (models/params.py;
    bfloat16 leaves as float32, exact), for loading into another package."""
    return params_to_numpy(params)
