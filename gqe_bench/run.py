"""Run one cell of the benchmark of graphqembed_tpu_torch once, on the card:

    python3 gqe_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints progress and the numbers it compares on standard error, and one
JSON line as the last line of standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device` (with `busy_s` and `window_s`
of the traced slice under --trace 1), `breakdown` under --trace 1, and
last `checks`, each compared number with its limit. Exits non-zero with no
result line when there is no card, too few cards, or the process holds
JAX or the JAX package once the window has closed.

Set-up time counts from this script's first line to the first timed step.
Build outputs stay in the checkout: the port builds its kernels into
`build/`, and the dataset is cached under `gqe_bench/cache/`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gqe_bench import harness  # noqa: E402


def log(msg: str) -> None:
    print(f"[gqe_bench] {msg}", file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float):
    """(result, checks) of one run of `cell` on `device`."""
    import torch

    torch.set_num_threads(1)
    log(f"imports done ({time.perf_counter() - t_start:.2f} s)")
    if device.type == "cuda":
        from graphqembed_tpu_torch.ops import cuda_build

        built = cuda_build.build_kernels()
        log(f"kernels ready ({built['seconds']:.2f} s)")
        torch.empty(0, device=device)       # the context, before its stats
        torch.cuda.reset_peak_memory_stats(device)
    return harness.driver(cell).run(cell, seed, seconds, trace, device,
                                    t_start, log=log)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = harness.Cell(args.workload)
    device = harness.cuda_device(cell.chips)
    import graphqembed_tpu_torch  # noqa: F401  (fails outside a checkout)

    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        log(f"the process holds {bad}: the port must not load JAX or the "
            "JAX package")
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
