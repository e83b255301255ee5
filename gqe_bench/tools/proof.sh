#!/bin/bash
# That the committed files are enough: one run of a cell from a checkout of
# them (`git archive`), and that the harness refuses, non-zero and with no
# result line, in a directory holding only BENCHMARK.json and gqe_bench/.
#
#   bash gqe_bench/tools/proof.sh <checkout> <out dir> <cell> <seconds>
set -u
CHECKOUT=$(realpath "$1"); OUT=$(realpath -m "$2"); CELL=$3; SECS=$4
mkdir -p "$OUT"
cd "$CHECKOUT" || exit 1
python3 gqe_bench/run.py --workload "$CELL" --seed 3141592653 \
  --seconds "$SECS" --trace 0 > "$OUT/proof.out" 2> "$OUT/proof.err"
echo "checkout run rc=$?" | tee -a "$OUT/index.txt"
ONLY=$(mktemp -d)
cp BENCHMARK.json "$ONLY/" && cp -r gqe_bench "$ONLY/"
rm -rf "$ONLY/gqe_bench/cache"
(cd "$ONLY" && python3 gqe_bench/run.py --workload "$CELL" --seed 7 \
  --seconds 5 --trace 0 > "$OUT/only.out" 2> "$OUT/only.err"
 echo "bench-only run rc=$? stdout_bytes=$(wc -c < "$OUT/only.out")" \
   | tee -a "$OUT/index.txt")
rm -rf "$ONLY"
