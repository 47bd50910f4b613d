#!/usr/bin/env bash
# Data-parallel evaluation, one process per card on this host (the
# counterpart of tools/dist_test.sh):
#   pavenet_tpu_torch/tools/dist_test.sh CONFIG CHECKPOINT GPUS [options]
# Each rank runs its shard of data.test; rank 0 gathers the detections,
# writes --out and evaluates.
CONFIG=$1
CHECKPOINT=$2
GPUS=$3
shift 3
PORT=${PORT:-29500}
ROOT=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python -m torch.distributed.run --nproc_per_node="$GPUS" \
    --master_port="$PORT" -m pavenet_tpu_torch.tools.test "$CONFIG" \
    "$CHECKPOINT" "$@"
