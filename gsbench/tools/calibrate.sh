#!/bin/bash
# The readings behind the limits of `correct`, on the card, both cells:
# the program on 12 seeds, the control on 3 of them, each fault on 3
# others.  Writes <out>/calibrate_<cell>.json.
#   bash gsbench/tools/calibrate.sh <out>
set -u
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
P=3200000011,3200000027,3200000049,3200000061,3200000083,3200000101,3200000127,3200000149,3200000161,3200000181,3200000203,3200000223
C=3200000011,3200000027,3200000049
F=3210000007,3210000019,3210000037
dir=$1
mkdir -p "$dir"
python3 gsbench/tools/calibrate.py --workload n3d_flame_steak.view_sweep \
  --seeds $P --control-seeds $C --fault-seeds $F --faults alter \
  --seconds 2 --out "$dir"/calibrate_n3d_flame_steak.view_sweep.json \
  > "$dir"/calibrate_view.log 2>&1
echo "view rc=$?"
python3 gsbench/tools/calibrate.py --workload dnerf_standup.train_b4 \
  --seeds $P --control-seeds $C --fault-seeds $F \
  --faults unchanged,half_batch --seconds 2 \
  --out "$dir"/calibrate_dnerf_standup.train_b4.json \
  > "$dir"/calibrate_train.log 2>&1
echo "train rc=$?"
