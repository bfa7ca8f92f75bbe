"""JAX param tree -> state dict under the original reference's names: the
inverse of ``pnp_vcve_tpu/core/convert.py: convert_generator_state_dict``
(:59-173), for the generator with deform='vos' and vsr=False in every block
form: conv2 an expert bank or (blocktype 'drt_woqp') a plain conv, conv1 a
plain conv or (one_layer=False) an expert bank (the layouts of :106-120).

Layouts: flax Dense ``(in, out)`` -> Linear ``(out, in)``; HWIO -> OIHW;
expert bank ``(K, kh, kw, in, out)`` -> ``(K, out, in, kh, kw)``; the stacked
partition kernel ``(in, 3, out)`` -> three 1x1 convs ``(out, in, 1, 1)``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax_params", "block_state_dict"]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _linear(out: dict, prefix: str, p: Mapping):
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _oihw(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _conv_or_bank(out: dict, blk: Mapping, name: str):
    """``blk[name]`` an expert bank, or ``blk[name + '_kernel']`` and
    ``blk[name + '_bias']`` a plain 3x3 conv -> ``name.weight/.bias``."""
    if name in blk:
        bank = np.asarray(blk[name]["bank"])
        out[f"{name}.weight"] = _t(np.transpose(bank, (0, 4, 3, 1, 2)))
        out[f"{name}.bias"] = _t(blk[name]["bias_bank"])
    else:
        out[f"{name}.weight"] = _oihw(blk[f"{name}_kernel"])
        out[f"{name}.bias"] = _t(blk[f"{name}_bias"])


def block_state_dict(blk: Mapping) -> Dict[str, torch.Tensor]:
    """One JAX ``DRTBlock``'s params -> the port ``DRTBlock``'s state dict."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_or_bank(sd, blk, "conv2")
    _conv_or_bank(sd, blk, "conv1")
    pk = np.asarray(blk["par_kernel"])
    for r, name in enumerate(("conv16x16", "conv16x8", "conv8x8")):
        sd[f"{name}.weight"] = _t(pk[:, r, :].T[:, :, None, None])
    return sd


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy or JAX arrays) of ``pnp_vcve_tpu.models.PnPVCVE``
    -> float32 state dict loadable with ``load_state_dict(strict=True)`` by
    ``pnp_vcve_torch.models.pnp_vcve.PnPVCVE``."""
    sd: Dict[str, torch.Tensor] = {}
    bp = params["base_predictor"]
    _linear(sd, "BasePredictor.BaseNet.0", bp["fc0"])
    _linear(sd, "BasePredictor.BaseNet.2", bp["fc1"])
    if "bias_predictor" in params:
        pb = params["bias_predictor"]
        if "fc0" in pb:  # SEModule
            _linear(sd, "BiasePredictor.fc.0", pb["fc0"])
            _linear(sd, "BiasePredictor.fc.2", pb["fc1"])
        else:  # BiasPredictor
            for name in ("qf_embed", "to_gamma", "to_beta"):
                if name in pb:
                    _linear(sd, f"BiasePredictor.{name}.0", pb[name])

    for side in ("backward", "forward"):
        tree = params[side]
        if "deform_align" in tree or any(k.startswith("upsample") for k in tree):
            raise NotImplementedError(
                "deform basic/fvc and vsr=True weights are not ported "
                "(ROADMAP Queue A item 2b)"
            )
        rb = tree["resblocks"]
        pre = f"{side}_resblocks"
        sd[f"{pre}.input_conv.0.weight"] = _oihw(rb["input_conv_kernel"])
        sd[f"{pre}.input_conv.0.bias"] = _t(rb["input_conv_bias"])
        i = 0
        while f"block{i}" in rb:
            sd.update({f"{pre}.main.{i}.{k}": v
                       for k, v in block_state_dict(rb[f"block{i}"]).items()})
            i += 1

    fwd = params["forward"]
    sd["conv_hr.weight"] = _oihw(fwd["conv_hr_kernel"])
    sd["conv_hr.bias"] = _t(fwd["conv_hr_bias"])
    sd["conv_last.weight"] = _oihw(fwd["conv_last_kernel"])
    sd["conv_last.bias"] = _t(fwd["conv_last_bias"])
    return sd
