"""The spreads that the bounds of BENCHMARK.json are set from, read from
the runs that `sets.sh` wrote: for each cell and end-to-end metric, each
set's median and its quartile spread (the distance between the first and
the third quartile of `statistics.quantiles(values, n=4)`, over the
median), every run's `correct`, and the largest reading of each compared
number beside its limit.

    python3 gqe_bench/tools/spread.py <out dir>
"""

import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(out_dir: str) -> int:
    runs = defaultdict(dict)
    for p in sorted(Path(out_dir).glob("*.out")):
        cell, tag = p.name[:-4].rsplit(".", 1)
        lines = p.read_text().strip().splitlines()
        runs[cell][tag] = json.loads(lines[-1]) if lines else None
    for cell, tags in runs.items():
        print(f"== {cell}")
        bad = [t for t, r in tags.items() if not r or r["correct"] is not True]
        print(f"runs {len(tags)}, not correct: {bad}")
        for name in sorted({m for r in tags.values() if r
                            for m in r["metrics"]}):
            for s in "AB":
                vals = [tags[t]["metrics"][name]["value"] for t in sorted(tags)
                        if t.startswith(s) and tags[t]
                        and name in tags[t]["metrics"]]
                if len(vals) >= 2:
                    print(f"{name} set {s}: median {statistics.median(vals)!r}"
                          f" spread {spread(vals):.5%} values {vals}")
            for t in ("first", "T1", "T2", "T3"):
                r = tags.get(t)
                if r and name in r["metrics"]:
                    print(f"{name} {t}: {r['metrics'][name]['value']!r}")
        worst = defaultdict(float)
        for r in tags.values():
            for k, c in (r or {}).get("checks", {}).items():
                worst[k] = max(worst[k], c["value"])
                limit = c["limit"]
                worst[k + " limit"] = limit
        print("largest readings:", json.dumps(worst))
        peaks = [r["device"]["memory_peak_bytes"] for r in tags.values() if r]
        print(f"memory peak: {max(peaks)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
