#!/bin/bash
# The readings behind the limits of `correct`, on the card: for each cell
# the program on 12 seeds, the control on 3 of them, each fault on 3
# others.  Writes <out>/calibrate_<cell>.json (and .log).
#   bash gsbench/tools/calibrate.sh <out> [<cell> ...]   (no cell: all)
set -u
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
P=3200000011,3200000027,3200000049,3200000061,3200000083,3200000101,3200000127,3200000149,3200000161,3200000181,3200000203,3200000223
C=3200000011,3200000027,3200000049
F=3210000007,3210000019,3210000037
dir=$1; shift
want=" ${*:-all} "
mkdir -p "$dir"
cal() {  # <cell> <faults>
  case "$want" in *" all "*|*" $1 "*) ;; *) return ;; esac
  python3 gsbench/tools/calibrate.py --workload "$1" \
    --seeds $P --control-seeds $C --fault-seeds $F --faults "$2" \
    --seconds 2 --out "$dir/calibrate_$1.json" > "$dir/calibrate_$1.log" 2>&1
  echo "$1 rc=$?"
}
cal n3d_flame_steak.view_sweep alter
cal dnerf_standup.train_b4 unchanged,half_batch
cal n3d_flame_steak.train_b4 unchanged,half_batch
