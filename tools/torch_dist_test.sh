#!/usr/bin/env bash
# The CLI contract of tools/dist_test.sh for the PyTorch/CUDA port:
#   ./tools/torch_dist_test.sh CONFIG CKPT GPUS [--testdir_lr D --testdir_gt D --save-path P ...]
# starts GPUS ranks of tools/torch_test.py under torchrun on this host; rank r
# takes the card r % (local cards) and every GPUS-th clip from r, and the
# dataset mean is reduced over the ranks. GPUS may exceed the card count
# (ranks then share a card). PYTHON names the interpreter (default python3).
set -euo pipefail

CONFIG=$1
CKPT=$2
GPUS=$3
shift 3

exec "${PYTHON:-python3}" -m torch.distributed.run --standalone --nproc_per_node="$GPUS" \
    "$(dirname "$0")/torch_test.py" "$CONFIG" "$CKPT" --launcher pytorch --multihost "$@"
