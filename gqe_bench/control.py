"""The readings that the limits of `limits/<workload>.json` are set from,
at a cell's own sizes, in one process (the set-up is paid once). The
cell's driver (`<kind>_cell.py`, by its traffic's `kind`) takes them with
its `readings`:

- the program's, on each of `--seeds` (the lower readings);
- on the first `--control` of them, the control: the reference in the
  program's place in the precision below the configuration's (TF32
  operands: `reference.gqe_ref.control`);
- on the same seeds, the faults the driver plants (a training cell: half
  of each batch left out, the mean taken over the rest, in the reference
  put in the program's place; the sampler without its hard negatives, or
  with one on every step; the step count held inside a call). A step that
  returns its state unchanged reads 1 on `step_gap` by its definition and
  needs no run.

    python3 gqe_bench/control.py --workload bio-d128.train-onthefly \\
        --seeds 12 --control 3 --out control.json

The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gqe_bench import harness  # noqa: E402


def log(msg: str) -> None:
    print(f"[control] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first_seed", type=int, default=1_000_003)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    device = harness.cuda_device(cell.chips)
    from graphqembed_tpu_torch.ops import cuda_build

    cuda_build.build_kernels()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    driver = harness.driver(cell)
    rows = driver.readings(cell, seeds, args.control, device, log)
    out = {"workload": args.workload, "traffic": cell.traffic, "rows": rows,
           "device": harness.device_info(device, cell.chips)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
