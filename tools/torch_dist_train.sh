#!/usr/bin/env bash
# The CLI contract of tools/dist_train.sh for the PyTorch/CUDA port:
#   ./tools/torch_dist_train.sh CONFIG GPUS [--work-dir D --exp_name NAME --device cpu ...]
# starts GPUS ranks of tools/torch_train.py under torchrun on this node; they
# train data-parallel (a global batch of samples_per_gpu x ranks, gradients
# averaged every step). Rank r takes the card r % (local cards); GPUS may
# exceed the card count (ranks then share a card over gloo). Across nodes,
# set NNODES (> 1), NODE_RANK, MASTER_ADDR and MASTER_PORT on each node;
# they pass to torchrun and the run gets --multihost. PYTHON names the
# interpreter (default python3).
set -euo pipefail

CONFIG=$1
GPUS=$2
shift 2

NNODES=${NNODES:-1}
if [[ "$NNODES" -gt 1 ]]; then
  RDZV=(--nnodes="$NNODES" --node_rank="${NODE_RANK:?NODE_RANK not set}"
        --master_addr="${MASTER_ADDR:?MASTER_ADDR not set}"
        --master_port="${MASTER_PORT:?MASTER_PORT not set}")
  EXTRA=(--multihost)
else
  RDZV=(--standalone)
  EXTRA=()
fi

exec "${PYTHON:-python3}" -m torch.distributed.run "${RDZV[@]}" --nproc_per_node="$GPUS" \
    "$(dirname "$0")/torch_train.py" "$CONFIG" --launcher pytorch ${EXTRA[@]+"${EXTRA[@]}"} "$@"
