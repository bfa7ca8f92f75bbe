#!/usr/bin/env python
"""Publish a checkpoint of the PyTorch/CUDA port: keep the generator's
weights, drop the optimizer, schedule and loop state, and tag the file with
its content hash (the port's counterpart of tools/publish_model.py;
reference tools/publish_model.py:18-31).

    python tools/torch_publish_model.py in_ckpt out_prefix

``in_ckpt`` is a training checkpoint of tools/torch_train.py
(``<work_dir>/ckpt/<step>.pth``) or a ``.pth`` state dict. The result,
``<out_prefix>-<first 8 hex digits of its sha256>.pth``, loads in
tools/torch_test.py, tools/torch_export_model.py and ``apis.init_model``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description="Publish a PnP-VCVE checkpoint")
    p.add_argument("in_ckpt", help="training checkpoint or state dict (.pth)")
    p.add_argument("out_prefix", help="output path prefix; -<hash8>.pth appended")
    args = p.parse_args(argv)

    from pnp_vcve_torch.core.checkpoint import publish_state_dict

    dst = publish_state_dict(args.in_ckpt, args.out_prefix)
    print(f"published -> {dst}")
    return dst


if __name__ == "__main__":
    main()
