#!/bin/bash
# The runs that the bounds of BENCHMARK.json are set from, for each cell:
# a first run (a fresh checkout's build and dataset cache), two sets of six
# runs with the same six seeds in both, and three traced runs, each a new
# process, one after another.
#
#   bash gqe_bench/tools/sets.sh <checkout> <out dir> <seconds> <cell>...
#
# <checkout> holds the committed files (`git archive`); each run's standard
# output and error go to <out dir>/<cell>.<tag>.{out,err}, and one line a
# run to <out dir>/index.txt. gqe_bench/tools/spread.py reads them.
set -u
CHECKOUT=$1; OUT=$(realpath -m "$2"); SECS=$3; shift 3
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader \
  > "$OUT/card.txt"
cd "$CHECKOUT" || exit 1
SEEDS="2147483659 2148483662 2149483665 2150483668 2151483671 2152483674"
one() {  # cell tag seed trace
  local t0=$(date +%s)
  python3 gqe_bench/run.py --workload "$1" --seed "$3" --seconds "$SECS" \
    --trace "$4" > "$OUT/$1.$2.out" 2> "$OUT/$1.$2.err"
  echo "$1 $2 seed=$3 trace=$4 rc=$? wall=$(( $(date +%s) - t0 ))" \
    | tee -a "$OUT/index.txt"
}
for cell in "$@"; do
  one "$cell" first 3000000019 0
  i=0; for s in $SEEDS; do i=$((i+1)); one "$cell" A$i "$s" 0; done
  i=0; for s in $SEEDS; do i=$((i+1)); one "$cell" B$i "$s" 0; done
  i=0; for s in 2900000011 2900000023 2900000037; do
    i=$((i+1)); one "$cell" T$i "$s" 1
  done
done
