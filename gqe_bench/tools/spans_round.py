"""The program's spans in a training cell's traced round on the card: for
each seed, one run of the cell (its `<kind>_cell.py`) with the round
traced, whose events are reduced by `gqe_bench/spans.py` besides the
harness's own reduction; one JSON line a seed (the run's result and
checks, `spans`, and `ms_per_step`: device, host and idle ms a step per
span). PERF.md's breakdown per span comes from these lines.

    python3 gqe_bench/tools/spans_round.py \\
        --workload bio-d128.train-onthefly --seeds 2900000011 --seconds 1

Not part of a benchmark run.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gqe_bench import harness, run, spans, trace  # noqa: E402


def per_step(reduced: dict) -> dict:
    n = max(reduced["steps"], 1)
    return {name: {k: 1e3 * row[k] / n
                   for k in ("device_s", "host_s", "idle_s")}
            for name, row in reduced["spans"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    device = harness.cuda_device(cell.chips)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)
    kept = {}
    reduce_events = trace.reduce_events

    def keep(events):
        kept["events"] = events
        return reduce_events(events)

    trace.reduce_events = keep
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res, checks = run.run_cell(cell, seed, args.seconds, True, device, t)
        reduced = spans.reduce(kept.pop("events"))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "wall": time.perf_counter() - t, **res,
                          "checks": checks, "spans": reduced,
                          "ms_per_step": per_step(reduced)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
