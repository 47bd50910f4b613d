#!/usr/bin/env bash
# Data-parallel training, one process per card on this host (the
# counterpart of tools/dist_train.sh):
#   pavenet_tpu_torch/tools/dist_train.sh CONFIG GPUS [train options]
# torch.distributed.run sets RANK, WORLD_SIZE, LOCAL_RANK and the
# rendezvous address; each rank trains on cuda:LOCAL_RANK with the NCCL
# backend unless --dist-backend says otherwise.
CONFIG=$1
GPUS=$2
shift 2
PORT=${PORT:-29500}
ROOT=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python -m torch.distributed.run --nproc_per_node="$GPUS" \
    --master_port="$PORT" -m pavenet_tpu_torch.tools.train "$CONFIG" "$@"
