"""Logging and environment reporting (counterpart of
pnp_vcve_tpu/utils/logging.py; reference mmedit/utils/logger.py:7-27, the
``collect_env`` report of tools/train.py:119-123 and the
TensorboardLoggerHook of configs/HR_davis_LR_128x128.py:229-234).

The rank is the default process group's (0 without one).
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
from pathlib import Path
from typing import Optional

from pnp_vcve_torch.parallel.multihost import rank_and_world

__all__ = ["get_root_logger", "collect_env", "TensorboardWriter", "JsonScalarWriter"]

_LOGGER_NAME = "pnp_vcve_torch"


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    """The timestamped root logger, to stdout and, on rank 0, to
    ``log_file``; other ranks are silenced to ERROR (reference
    logger.py:7-27). Each call sets the handlers anew, so one process can
    run several trainings, each logging to its own file."""
    logger = logging.getLogger(_LOGGER_NAME)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    rank, _ = rank_and_world()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file is not None and rank == 0:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    return logger


def collect_env() -> dict:
    """The environment report printed when training starts: Python, the
    platform, torch, CUDA, cuDNN, nvcc, the cards and the process group."""
    import platform

    import numpy as np
    import torch

    info = {
        "python": sys.version.replace("\n", " "),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "numpy": np.__version__,
        "cuda (torch built with)": torch.version.cuda or "none",
        "cuda available": torch.cuda.is_available(),
    }
    if torch.cuda.is_available():
        info["cudnn"] = torch.backends.cudnn.version()
        names: dict[str, list[int]] = {}
        for i in range(torch.cuda.device_count()):
            names.setdefault(torch.cuda.get_device_name(i), []).append(i)
        for name, ids in names.items():
            info["GPU " + ",".join(map(str, ids))] = name
    from pnp_vcve_torch.kernels.build import nvcc_path

    nvcc, info["nvcc"] = nvcc_path(), "none"
    if nvcc is not None:
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=30)
        if out.returncode == 0:
            info["nvcc"] = f"{nvcc}: {out.stdout.strip().splitlines()[-1]}"
    rank, world = rank_and_world()
    info["process group"] = f"rank {rank} of {world}"
    return info


class TensorboardWriter:
    """Scalar writer on tensorboardX, or ``torch.utils.tensorboard`` where
    only tensorboard is installed. It does nothing on ranks other than 0,
    and nothing, after one log line, when neither package is there."""

    def __init__(self, log_dir: str):
        self._w = None
        if rank_and_world()[0] != 0:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                logging.getLogger(_LOGGER_NAME).info(
                    "neither tensorboardX nor tensorboard is installed: no scalars are written")
                return
        self._w = SummaryWriter(log_dir)

    def scalars(self, step: int, **values: float):
        if self._w is None:
            return
        for k, v in values.items():
            self._w.add_scalar(k, v, step)

    def close(self):
        if self._w is not None:
            self._w.close()


class JsonScalarWriter:
    """Each ``scalars`` call as one line ``{"step": N, "<name>": value, ...}``
    appended to ``path``, unrounded (the text log rounds the loss to 5
    decimals), on rank 0 only; then the same call on ``inner`` (a
    :class:`TensorboardWriter`) where one is given."""

    def __init__(self, path: str, inner=None):
        self._path = path if rank_and_world()[0] == 0 else None
        self._inner = inner

    def scalars(self, step: int, **values: float):
        if self._path is not None:
            with open(self._path, "a") as f:
                f.write(json.dumps({"step": step, **{k: float(v) for k, v in values.items()}})
                        + "\n")
        if self._inner is not None:
            self._inner.scalars(step, **values)

    def close(self):
        if self._inner is not None:
            self._inner.close()
