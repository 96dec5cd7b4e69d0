#!/bin/bash
# Two sets of runs of a cell on the card, the same seeds in both sets, one
# process a run, each run's output kept under <out>/sets/:
#   bash gsbench/tools/sets.sh <out> <cell> <seconds> <trace 0|1> <seed> [<seed> ...]
# (with trace 1, one set; SETS="A" in the environment runs set A alone,
# SETS="B" set B alone).  The bounds of BENCHMARK.json are set from
# such sets (PERF.md section 2).
set -u
dir=$1; cell=$2; secs=$3; trace=$4; shift 4
mkdir -p "$dir/sets"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
sets="${SETS:-A B}"; [ "$trace" = 1 ] && sets="T"
for set in $sets; do for seed in "$@"; do
  out=$dir/sets/${cell}_${set}_${seed}
  python3 gsbench/run.py --workload "$cell" --seed "$seed" --seconds "$secs" \
    --trace "$trace" > "$out.out" 2> "$out.err"
  echo "$cell $set $seed rc=$? $(tail -1 "$out.out" | cut -c1-300)"
done; done
