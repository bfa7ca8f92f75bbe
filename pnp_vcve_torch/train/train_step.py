"""The eval step (counterpart of the eval half of
pnp_vcve_tpu/train/train_step.py: ``_model_inputs`` :34-42 and
``make_eval_step`` :89-106). Training is ROADMAP Queue A item 5."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MODEL_INPUT_KEYS", "make_eval_step"]

MODEL_INPUT_KEYS = ("lq", "qps", "slices", "mvs", "base_qps", "partitions")


def _model_inputs(batch):
    return dict(
        lrs=batch["lq"],
        qps=batch["qps"],
        slices=batch["slices"],
        mvs=batch["mvs"],
        base_qps=batch["base_qps"],
        par_map=batch["partitions"],
    )


def make_eval_step(model: torch.nn.Module):
    """``eval_step(batch, is_mirror_extended=False) -> (b, t, h, w, 3)`` float32
    numpy: the batch's numpy arrays go to the model's device, the forward
    runs under ``torch.inference_mode()``."""
    device = next(model.parameters()).device

    def eval_step(batch, is_mirror_extended: bool = False) -> np.ndarray:
        inputs = {
            k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in _model_inputs(batch).items()
        }
        with torch.inference_mode():
            out = model(**inputs, is_mirror_extended=is_mirror_extended)
        return out.cpu().numpy()

    return eval_step
