#!/usr/bin/env python
"""Package a (config, checkpoint) pair into a servable directory for the
PyTorch port's serving handler (tools/torch_serving_handler.py); the
counterpart of tools/deployment/pnp2servable.py.

    <output-folder>/<model-name>/
        MANIFEST.json   model name and version, the config and weights files
        config.py       the config, frozen: its ``_base_`` chain merged into
                        one file of literals
        weights.pth     the generator's state dict under the reference's
                        names (absent for a random-init servable)

Usage:
    python tools/torch_pnp2servable.py CONFIG CHECKPOINT --output-folder DIR
        [--model-name NAME] [--model-version 1.0] [--force]

CHECKPOINT is anything ``tools/torch_test.py`` loads (a ``.pth`` or ``.npz``
state dict, a training checkpoint of tools/torch_train.py) or ``-`` for a
seeded random init. An existing servable is refused unless ``--force``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WEIGHTS = "weights.pth"


def _freeze(cfg) -> str:
    """The merged config as Python source of literals."""
    lines = ['"""Frozen by tools/torch_pnp2servable.py."""', ""]
    lines += [f"{k} = {v!r}" for k, v in cfg.to_dict().items()]
    return "\n".join(lines) + "\n"


def pnp2servable(config_file: str, checkpoint: str, output_folder: str,
                 model_name: str | None = None, model_version: str = "1.0",
                 force: bool = False) -> Path:
    import torch

    from pnp_vcve_torch.core.checkpoint import read_state_dict
    from pnp_vcve_torch.core.config import Config

    cfg_path = Path(config_file)
    if not cfg_path.is_file():
        raise FileNotFoundError(f"config not found: {cfg_path}")
    if checkpoint != "-" and not Path(checkpoint).is_file():
        raise FileNotFoundError(f"checkpoint not found: {checkpoint}")
    name = model_name or cfg_path.stem
    out = Path(output_folder) / name
    if out.exists():
        if not force:
            raise FileExistsError(f"{out} exists (use --force to overwrite)")
        shutil.rmtree(out)
    cfg = Config.fromfile(cfg_path)
    frozen = _freeze(cfg)
    out.mkdir(parents=True)
    (out / "config.py").write_text(frozen)
    if Config.fromfile(out / "config.py").to_dict() != cfg.to_dict():
        shutil.rmtree(out)
        raise ValueError(f"{cfg_path} holds values that do not round-trip as literals")
    if checkpoint != "-":
        torch.save(read_state_dict(checkpoint), out / WEIGHTS)
    manifest = {
        "model": {
            "modelName": name,
            "modelVersion": model_version,
            "configFile": "config.py",
            "serializedFile": WEIGHTS if checkpoint != "-" else None,
        },
        "runtime": "torch",
    }
    (out / "MANIFEST.json").write_text(json.dumps(manifest, indent=2))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("checkpoint", help="state dict (.pth/.npz), training checkpoint, or '-'")
    p.add_argument("--output-folder", required=True)
    p.add_argument("--model-name", default=None)
    p.add_argument("--model-version", default="1.0")
    p.add_argument("-f", "--force", action="store_true")
    args = p.parse_args(argv)
    out = pnp2servable(args.config, args.checkpoint, args.output_folder, args.model_name,
                       args.model_version, args.force)
    print(f"servable written to {out}")
    return out


if __name__ == "__main__":
    main()
