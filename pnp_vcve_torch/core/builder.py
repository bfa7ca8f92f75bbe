"""Builders: config dicts -> the port's objects (counterpart of the parts of
pnp_vcve_tpu/core/builder.py that the flagship enhancement path uses:
the generator :33-100, the restorer :568-578, the eval datasets
:1117-1192).

The registries carry the reference type names, so the shipped configs
(``configs/HR_davis_LR_128x128.py`` and its ``_serving_tpu`` variant) load
unchanged. Types the port does not have yet raise ``NotImplementedError``
naming the ROADMAP item that will port them. The datasets are the JAX
package's shared, JAX-free data classes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from pnp_vcve_tpu.core.registry import Registry
from pnp_vcve_torch.models.pnp_vcve import PnPVCVE
from pnp_vcve_torch.models.restorer import Restorer

__all__ = [
    "BACKBONES",
    "MODELS",
    "DATASETS",
    "build_generator",
    "build_restorer",
    "build_dataset",
]

BACKBONES = Registry("backbones")
MODELS = Registry("models")
DATASETS = Registry("datasets")


def _build(registry: Registry, cfg: dict, roadmap: str, **extra):
    typ = cfg.get("type")
    if typ not in registry:
        raise NotImplementedError(
            f"{registry.name} type {typ!r} is not ported to pnp_vcve_torch yet "
            f"(ROADMAP {roadmap})"
        )
    return registry.build(cfg, **extra)


@BACKBONES.register(
    name="PnPVCVE",
    aliases=("IconVSR_restore_wo_refill_mv_ipb_fast_domain_dynamic_with_par",),
)
def _build_pnp_vcve(
    *,
    device,
    seed: int = 0,
    mid_channels=64,
    num_blocks=8,
    num_experts=6,
    expert_softmax=True,
    use_base_qp=True,
    with_bias=True,
    with_se=True,
    with_cat=True,
    one_layer=True,
    channel_first=True,
    align_key=True,
    vsr=False,
    flow_inter="bilinear",
    blocktype="drt",
    deform="vos",
    # TPU serving knobs, accepted so the serving config loads: on the port
    # CUDA tensors always take the kernels, and the warp kernel is exact for
    # every warp_impl domain
    use_pallas_kernels=False,
    warp_impl="padgather",
    # reference knobs with no effect on the flagship path (as in the JAX builder)
    **_ignored,
):
    unported = {
        "vsr=True": vsr,
        f"deform={deform!r}": deform != "vos",
        f"blocktype={blocktype!r}": blocktype != "drt",
        "one_layer=False": not one_layer,
        "channel_first=False": not channel_first,
        f"flow_inter={flow_inter!r}": flow_inter != "bilinear",
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(
                f"PnPVCVE {what} is not ported to pnp_vcve_torch yet "
                "(ROADMAP Queue A item 2b)"
            )
    # build without drawing from the global RNG, then init from a seeded
    # generator on the CPU
    with torch.device("meta"):
        model = PnPVCVE(
            mid_channels=mid_channels,
            num_blocks=num_blocks,
            num_experts=num_experts,
            expert_softmax=expert_softmax,
            use_base_qp=use_base_qp,
            with_bias=with_bias,
            with_se=with_se,
            with_cat=with_cat,
            align_key=align_key,
        )
    model = model.to_empty(device=device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def build_generator(cfg: dict, *, device, seed: int = 0):
    """Generator on ``device``, randomly initialised from ``seed``."""
    return _build(BACKBONES, dict(cfg), "Queue A item 8", device=device, seed=seed)


@MODELS.register(name="Restorer", aliases=("BasicVSR", "BasicRestorer"))
def _build_restorer(generator: dict, test_cfg=None, *, device, seed=0, **_loss_and_train):
    test_cfg = dict(test_cfg or {"metrics": ["PSNR", "SSIM"], "crop_border": 0})
    return Restorer(
        generator=build_generator(dict(generator), device=device, seed=seed),
        test_cfg=test_cfg,
    )


def build_restorer(model_cfg: dict, test_cfg: Optional[dict] = None, *, device, seed: int = 0):
    cfg = dict(model_cfg)
    if test_cfg is not None:
        cfg["test_cfg"] = test_cfg
    return _build(MODELS, cfg, "Queue A item 8", device=device, seed=seed)


def _loader_params(pipeline):
    from pnp_vcve_tpu.data.compose import Compose

    tf = Compose(pipeline) if pipeline else None
    return tf, (tf or Compose([])).loader_params()


def _test_dataset(lq_folder, gt_folder, clips, num_input_frames, scale, pipeline):
    from pnp_vcve_tpu.data.datasets import CompressTestDataset

    tf, p = _loader_params(pipeline)
    return CompressTestDataset(
        transforms=tf,
        lq_folder=lq_folder,
        gt_folder=gt_folder,
        qp_slice_file=p["qp_slice_file"],
        clips=clips,
        num_input_frames=num_input_frames,
        scale=scale,
        filename_tmpl=p["filename_tmpl"],
        replace_qp_with_ipb=p["replace_qp_with_ipb"],
    )


@DATASETS.register(name="SRREDSMultipleGTCompressDataset")
def _build_reds_test(lq_folder, gt_folder, num_input_frames=100, scale=1, pipeline=None,
                     val_partition="REDS4", test_mode=True, **_ignored):
    """REDS4 (or REDS val 240-269) clips of 100 frames."""
    from pnp_vcve_tpu.data.datasets import REDS4_CLIPS, ClipIndex

    val = (
        REDS4_CLIPS if val_partition == "REDS4"
        else tuple(f"{i:03d}" for i in range(240, 270))
    )
    clips = [ClipIndex(n, 100) for n in val]
    return _test_dataset(lq_folder, gt_folder, clips, num_input_frames, scale, pipeline)


@DATASETS.register(
    name="SRFolderMultipleGTDataset",
    aliases=("SRVid4Dataset", "SRTestMultipleGTDataset", "DAVISMultipleGTCompressDataset"),
)
def _build_folder_test(lq_folder, gt_folder, num_input_frames=100, scale=1, pipeline=None,
                       test_mode=True, **_ignored):
    """Every clip folder under ``lq_folder``, with its PNG count as length."""
    from pnp_vcve_tpu.data.datasets import ClipIndex

    names = sorted(d.name for d in os.scandir(lq_folder) if d.is_dir())
    clips = [
        ClipIndex(n, sum(1 for f in os.scandir(os.path.join(lq_folder, n))
                         if f.name.endswith(".png")))
        for n in names
    ]
    return _test_dataset(lq_folder, gt_folder, clips, num_input_frames, scale, pipeline)


def build_dataset(cfg: dict):
    """One whole-clip eval dataset."""
    return _build(DATASETS, dict(cfg), "Queue A item 3")
