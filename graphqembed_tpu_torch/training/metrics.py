"""Structured metrics: console/file logging, a JSONL event stream with
optional TensorBoard scalars, and the edges traversed + scored per query
of each structure. The same interface as the JAX package's
`training/metrics.py`, less its throughput meter."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

# edges traversed+scored per query of each structure: projections (traversed)
# + 1 positive + 1 negative score (scored) per train step
EDGES_PER_QUERY = {"1p": 3, "2p": 4, "3p": 5, "2i": 4, "3i": 5, "ip": 5, "pi": 5}

LOGGER_NAME = "graphqembed_tpu_torch"


def setup_logging(log_dir: str | Path | None = None,
                  level: int = logging.INFO) -> logging.Logger:
    """Console + optional file (log_dir/train.log) logging."""
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        logger.addHandler(h)
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(Path(log_dir) / "train.log")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """JSONL event stream (run_dir/metrics.jsonl) + TensorBoard scalars
    when asked for and tensorboardX is importable."""

    def __init__(self, run_dir: str | Path, tensorboard: bool = False):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.run_dir / "metrics.jsonl", "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:  # tensorboardX is optional
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(str(self.run_dir / "tb"))
        self._t0 = time.time()

    def write(self, step: int, **scalars) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3), **scalars}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

