"""JAX param tree -> state dict of the port's generator: the inverse of
``pnp_vcve_tpu/core/convert.py: convert_generator_state_dict`` (:59-173),
for the generator in every form the JAX builder accepts: conv2 an expert
bank or (blocktype 'drt_woqp') a plain conv, conv1 a plain conv or
(one_layer=False) an expert bank (the layouts of :106-120), each sweep's
deformable aligner (deform 'basic'/'fvc') and the vsr upsampling convs.

The names are the original reference's, except that each sweep owns its
aligner (``{backward,forward}_deform_align.*``), as in JAX, where the
reference shares one (``deform_align.*``); :func:`shared_aligner_to_sweeps`
writes a reference state dict's one aligner into both, as JAX's converter
does (:133-155).

Layouts: flax Dense ``(in, out)`` -> Linear ``(out, in)``; HWIO -> OIHW;
expert bank ``(K, kh, kw, in, out)`` -> ``(K, out, in, kh, kw)``; the stacked
partition kernel ``(in, 3, out)`` -> three 1x1 convs ``(out, in, 1, 1)``.

The baselines: :func:`spynet_state_dict` and :func:`bvpp_state_dict` invert
``pnp_vcve_tpu/core/convert_baselines.py: convert_spynet`` (:63-72) and
``convert_bvpp_pqf`` (:115-153) for SPyNet and the BasicVSR++ family (and
carry the full-size input's ``feat_down{0,1}``, which that converter does
not read, to the reference's ``feat_extract.{0,2}``);
:func:`mfqev2_state_dict` carries MFQEv2's flax ``params`` and
``batch_stats``. :func:`stdf_state_dict` inverts ``convert_stdf`` (:75-102):
STDF under the reference's names, the transposed convs' kernels flipped
back to ``ConvTranspose2d``'s ``(in, out, kh, kw)``. DCNGAN (generator and
discriminator), MW-GAN and SIDECVSR follow the JAX tree in PyTorch's forms
(:func:`dcngan_state_dict`, :func:`dcngan_disc_state_dict`,
:func:`mwgan_state_dict`, :func:`sidecvsr_state_dict`): each flax module
path becomes a dotted name, a conv's HWIO ``kernel`` (or a PAC's
``weight``) an OIHW ``weight``, a Dense ``kernel`` a Linear ``weight``;
``bias`` and the batch-statistics norms' ``scale`` stay as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = [
    "from_jax_params", "block_state_dict", "aligner_state_dict", "shared_aligner_to_sweeps",
    "spynet_state_dict", "bvpp_state_dict", "mfqev2_state_dict", "stdf_state_dict",
    "dcngan_state_dict", "dcngan_disc_state_dict", "mwgan_state_dict", "sidecvsr_state_dict",
]


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


def aligner_state_dict(da: Mapping) -> Dict[str, torch.Tensor]:
    """One JAX deformable aligner's params -> the port aligner's state dict
    (``weight``, ``bias``, ``conv_offset.{0,2}.*``)."""
    sd = {"weight": _oihw(da["weight"]), "bias": _t(da["bias"])}
    for i, name in ((0, "conv0"), (2, "conv1")):
        sd[f"conv_offset.{i}.weight"] = _oihw(da["conv_offset"][name]["kernel"])
        sd[f"conv_offset.{i}.bias"] = _t(da["conv_offset"][name]["bias"])
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
        if "deform_align" in tree:
            sd.update({f"{side}_deform_align.{k}": v
                       for k, v in aligner_state_dict(tree["deform_align"]).items()})
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
    for up in ("upsample1", "upsample2"):
        if f"{up}_kernel" in fwd:
            sd[f"{up}.upsample_conv.weight"] = _oihw(fwd[f"{up}_kernel"])
            sd[f"{up}.upsample_conv.bias"] = _t(fwd[f"{up}_bias"])
    return sd


def shared_aligner_to_sweeps(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict under the reference's names, its one shared
    ``deform_align.*`` written into both sweeps' aligners; other entries
    unchanged."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("deform_align."):
            for side in ("backward", "forward"):
                out[f"{side}_{k}"] = v.clone()
        else:
            out[k] = v
    return out


def _conv(out: dict, prefix: str, p: Mapping):
    """A flax ``{kernel, bias}`` conv -> ``prefix.weight`` (OIHW), ``.bias``."""
    out[f"{prefix}.weight"] = _oihw(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def spynet_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``SPyNet`` params -> the reference's
    ``basic_module.{i}.basic_module.{j}.conv.*`` under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"basic_module{i}" in params:
        mod = params[f"basic_module{i}"]
        j = 0
        while f"conv{j}" in mod:
            _conv(sd, f"{prefix}basic_module.{i}.basic_module.{j}.conv", mod[f"conv{j}"])
            j += 1
        i += 1
    return sd


def _res_blocks(out: dict, prefix: str, tree: Mapping):
    """JAX ``ResidualBlocksWithInputConv`` -> ``prefix.main.{0, 2.<i>.conv1,
    2.<i>.conv2}``."""
    _conv(out, f"{prefix}.main.0", tree["input_conv"])
    i = 0
    while f"block{i}_conv1" in tree:
        for j in (1, 2):
            _conv(out, f"{prefix}.main.2.{i}.conv{j}", tree[f"block{i}_conv{j}"])
        i += 1


def bvpp_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``BasicVSRPlusPlus`` / ``BasicVSRPlusPlusPQF`` params -> the
    port's state dict under the reference's names."""
    sd: Dict[str, torch.Tensor] = {}
    if "feat_down0" in params:  # full-size input: two stride-2 convs first
        _conv(sd, "feat_extract.0", params["feat_down0"])
        _conv(sd, "feat_extract.2", params["feat_down1"])
        _res_blocks(sd, "feat_extract.4", params["feat_extract"])
    else:
        _res_blocks(sd, "feat_extract", params["feat_extract"])
    for branch in ("backward_1", "forward_1", "backward_2", "forward_2"):
        align = params[branch]["deform_align"]
        sd[f"deform_align.{branch}.weight"] = _oihw(align["weight"])
        sd[f"deform_align.{branch}.bias"] = _t(align["bias"])
        for ours, ref in enumerate((0, 2, 4, 6)):
            _conv(sd, f"deform_align.{branch}.conv_offset.{ref}", align[f"conv_offset{ours}"])
        _res_blocks(sd, f"backbone.{branch}", params[branch]["backbone"])
    _res_blocks(sd, "reconstruction", params["reconstruction"])
    for up in ("upsample1", "upsample2"):
        _conv(sd, f"{up}.upsample_conv",
              {"kernel": params[f"{up}_kernel"], "bias": params[f"{up}_bias"]})
    _conv(sd, "conv_hr", params["conv_hr"])
    _conv(sd, "conv_last", params["conv_last"])
    sd.update(spynet_state_dict(params["spynet"], "spynet."))
    return sd


def mfqev2_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``MFQEv2`` variables (``params`` and ``batch_stats``) -> the
    port's state dict: convs ``weight``/``bias``, PReLU ``weight``,
    BatchNorm ``weight``, ``bias``, ``running_mean``, ``running_var``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = spynet_state_dict(params["spynet"], "spynet.")
    for ks in (3, 5, 7):
        for j in range(3):
            _conv(sd, f"ks{ks}_conv{j}", params[f"ks{ks}_conv{j}"])
    i = 0
    while f"rec{i}" in stats:
        p, bn = params[f"rec{i}"], stats[f"rec{i}"]["bn"]
        _conv(sd, f"rec{i}.conv", p["conv"])
        sd[f"rec{i}.prelu.weight"] = _t(np.reshape(p["prelu"]["negative_slope"], (1,)))
        sd[f"rec{i}.bn.weight"] = _t(p["bn"]["scale"])
        sd[f"rec{i}.bn.bias"] = _t(p["bn"]["bias"])
        sd[f"rec{i}.bn.running_mean"] = _t(bn["mean"])
        sd[f"rec{i}.bn.running_var"] = _t(bn["var"])
        sd[f"rec{i}.bn.num_batches_tracked"] = torch.tensor(0)
        i += 1
    _conv(sd, f"rec{i}", params[f"rec{i}"])
    return sd


def _conv_transpose(out: dict, prefix: str, p: Mapping):
    """A flax ``ConvTranspose`` ``{kernel (kh, kw, in, out), bias}`` ->
    ``ConvTranspose2d``'s ``weight (in, out, kh, kw)``, spatially flipped."""
    k = np.asarray(p["kernel"])[::-1, ::-1]
    out[f"{prefix}.weight"] = _t(np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _stdf_core(out: dict, prefix: str, tree: Mapping):
    """JAX ``_STDF`` -> the reference's ``in_conv.0``, ``dn_conv{i}.{0,2}``,
    ``tr_conv.{0,2,4}``, ``up_conv{i}.{0,2}``, ``out_conv.0``, ``offset_mask``
    and ``deform_conv`` under ``prefix``."""
    _conv(out, f"{prefix}in_conv.0", tree["in_conv"])
    i = 1
    while f"dn_conv{i}_0" in tree:
        _conv(out, f"{prefix}dn_conv{i}.0", tree[f"dn_conv{i}_0"])
        _conv(out, f"{prefix}dn_conv{i}.2", tree[f"dn_conv{i}_1"])
        _conv(out, f"{prefix}up_conv{i}.0", tree[f"up_conv{i}_0"])
        _conv_transpose(out, f"{prefix}up_conv{i}.2", tree[f"up_conv{i}_up"])
        i += 1
    _conv(out, f"{prefix}tr_conv.0", tree["tr_conv_0"])
    _conv(out, f"{prefix}tr_conv.2", tree["tr_conv_1"])
    _conv_transpose(out, f"{prefix}tr_conv.4", tree["tr_conv_up"])
    _conv(out, f"{prefix}out_conv.0", tree["out_conv"])
    _conv(out, f"{prefix}offset_mask", tree["offset_mask"])
    out[f"{prefix}deform_conv.weight"] = _oihw(tree["deform_kernel"])
    out[f"{prefix}deform_conv.bias"] = _t(tree["deform_bias"])


def stdf_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``STDFNet`` params -> the port's (the reference's) state dict."""
    sd: Dict[str, torch.Tensor] = {}
    _stdf_core(sd, "stdf.", params["stdf"])
    qe = params["qenet"]
    _conv(sd, "qenet.in_conv", qe["in_conv"])
    k = 0
    while f"hid_conv{k}" in qe:
        _conv(sd, f"qenet.hid_conv.{2 * k + 1}", qe[f"hid_conv{k}"])
        k += 1
    _conv(sd, "qenet.out_conv.1", qe["out_conv"])
    return sd


def _tree_state_dict(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax param tree -> dotted names: conv ``kernel`` (HWIO) or PAC
    ``weight`` -> OIHW ``weight``, Dense ``kernel`` -> Linear ``weight``,
    other leaves (``bias``, ``scale``) as they are."""
    sd: Dict[str, torch.Tensor] = {}
    for name, v in tree.items():
        if isinstance(v, Mapping):
            sd.update(_tree_state_dict(v, f"{prefix}{name}."))
        elif name in ("kernel", "weight") and np.ndim(v) == 4:
            sd[f"{prefix}weight"] = _oihw(v)
        elif name == "kernel":
            sd[f"{prefix}weight"] = _t(np.asarray(v).T)
        else:
            sd[f"{prefix}{name}"] = _t(v)
    return sd


def dcngan_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``DCNGANNet`` params -> the port's state dict: ``FA.*`` under
    STDF's names, ``QE.*`` the JAX tree."""
    sd: Dict[str, torch.Tensor] = {}
    _stdf_core(sd, "FA.", params["FA"])
    sd.update(_tree_state_dict(params["QE"], "QE."))
    return sd


def dcngan_disc_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``DCNGANDiscriminator`` params -> the port's state dict."""
    return _tree_state_dict(params)


def mwgan_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``DenseMWNetMiniPSNR`` params -> the port's state dict."""
    return _tree_state_dict(params)


def sidecvsr_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``SIDECVSR`` params -> the port's state dict."""
    return _tree_state_dict(params)
