"""Batch sweep of a training cell on the card: for each batch size, one run
of the cell's driver with the window untraced and one traced, in this
process, printing one JSON line each (the run's result and checks). The
cell's batch is chosen from these lines (PERF.md, Cells).

    python3 gqe_bench/tools/sweep.py --workload bio-d128.train-onthefly \\
        --batch_sizes 8192,16384,32768,65536 --seconds 8

Not part of a benchmark run.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gqe_bench import harness, run  # noqa: E402


def one(device, cell, trace: bool, seed: int, seconds: float) -> None:
    import torch

    t = time.perf_counter()
    res, checks = run.run_cell(cell, seed, seconds, trace, device, t)
    print(json.dumps({"workload": cell.name, "traffic": cell.traffic,
                      "trace": trace, "wall": time.perf_counter() - t, **res,
                      "checks": checks}), flush=True)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batch_sizes", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1_234_567_891)
    args = ap.parse_args(argv)
    base = harness.Cell(args.workload)
    device = harness.cuda_device(base.chips)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)
    for b in (int(x) for x in args.batch_sizes.split(",")):
        cell = harness.Cell.of(base.name, base.config,
                               dict(base.traffic, batch_size=b), base.limits,
                               base.end_to_end, base.per_layer, base.chips)
        for trace in (False, True):
            one(device, cell, trace, args.seed, args.seconds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
