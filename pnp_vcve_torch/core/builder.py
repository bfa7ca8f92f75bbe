"""Builders: config dicts -> the port's objects (counterpart of the parts of
pnp_vcve_tpu/core/builder.py that the flagship enhancement and training
paths and the eval entry point's modes use: the generator :33-100, the
baselines STDF, MFQEv2, the BasicVSR++ family, DCNGAN and SIDECVSR
:102-179 and MW-GAN :460-467, the discriminators :470-483 and :564, the
restorers :568-600, the train datasets :660-750, :905-1062 and :1195-1208,
the eval datasets :1064-1192, the optimizer :1211-1261).

The registries carry the reference type names, so the flagship configs load
unchanged. Types the port does not have yet raise ``NotImplementedError``
naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from pnp_vcve_torch.core.registry import Registry
from pnp_vcve_torch.data.compose import Compose
from pnp_vcve_torch.data.datasets import (
    REDS4_CLIPS,
    ClipIndex,
    CompressTestDataset,
    MixCompressTrainDataset,
    reds_train_clips,
)
from pnp_vcve_torch.data.extra_datasets import KittiPairDataset, VimeoMixDataset, VimeoTestDataset
from pnp_vcve_torch.data.loader import WeightedMixture
from pnp_vcve_torch.models.pnp_vcve import PnPVCVE
from pnp_vcve_torch.models.restorer import CenterFrameRestorer, Restorer
from pnp_vcve_torch.train.schedule import cosine_restart_schedule

__all__ = [
    "BACKBONES",
    "COMPONENTS",
    "MODELS",
    "DATASETS",
    "build_generator",
    "build_discriminator",
    "build_restorer",
    "build_dataset",
    "build_train_datasets",
    "build_optimizer",
]

BACKBONES = Registry("backbones")
COMPONENTS = Registry("components")
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
    deform_groups=16,
    remat=True,
    warp_impl="padgather",
    # the JAX serving flag: warp_impl='pf' refuses to run without it (as in
    # JAX); on the port CUDA tensors always take the kernels
    use_pallas_kernels=False,
    # reference knobs with no effect on the flagship path (as in the JAX builder)
    **_ignored,
):
    if blocktype not in ("drt", "drt_woqp"):
        raise NotImplementedError(f"blocktype={blocktype!r} not implemented yet")
    if deform not in ("vos", "basic", "fvc"):
        # 'stdf' raises in the reference too (iconvsr_ipb.py:26-28)
        raise NotImplementedError(f"No such DCN type: {deform!r}")
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
            one_layer=one_layer,
            channel_first=channel_first,
            blocktype=blocktype,
            align_key=align_key,
            vsr=vsr,
            flow_interpolation=flow_inter,
            deform=deform,
            deform_groups=deform_groups,
            remat=remat,
            warp_impl=warp_impl,
            use_pallas_kernels=use_pallas_kernels,
        )
    return _seeded(model, device, seed)


def _seeded(model: torch.nn.Module, device, seed: int):
    """A model built on ``meta`` (without drawing from the global RNG),
    moved to ``device`` and initialised from a seeded CPU generator."""
    model = model.to_empty(device=device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _known(kwargs: dict, names) -> dict:
    """The JAX builders' kwarg filters: the reference configs' other keys
    are dropped."""
    return {k: v for k, v in kwargs.items() if k in names}


_BVPP_KEYS = ("mid_channels", "num_blocks", "max_residue_magnitude", "is_low_res_input",
              "deform_groups")


@BACKBONES.register(name="STDFNet")
def _build_stdf(*, device, seed: int = 0, **kwargs):
    from pnp_vcve_torch.models.baselines import STDFNet

    with torch.device("meta"):
        model = STDFNet(**_known(kwargs, (
            "in_channels", "out_channels", "radius", "nf_stdf", "nb_stdf", "nf_stdf_out",
            "deform_ks", "nf_qe", "nb_qe")))
    return _seeded(model, device, seed)


@BACKBONES.register(name="DCNGANNet", aliases=("DCNGAN_Net",))
def _build_dcngan(*, device, seed: int = 0, **kwargs):
    from pnp_vcve_torch.models.baselines import DCNGANNet

    with torch.device("meta"):
        model = DCNGANNet(**_known(kwargs, ("in_channels", "radius", "nf_fa", "nb_fa")))
    return _seeded(model, device, seed)


@BACKBONES.register(name="SIDECVSR")
def _build_sidecvsr(*, device, seed: int = 0, **kwargs):
    from pnp_vcve_torch.models.baselines import SIDECVSR

    with torch.device("meta"):
        model = SIDECVSR(**_known(kwargs, ("nf", "nframes", "scg_n")))
    return _seeded(model, device, seed)


@BACKBONES.register(name="DenseMWNetMiniPSNR", aliases=("DenseMWNet_Mini_PSNR",))
def _build_mwgan(*, device, seed: int = 0, **kwargs):
    """The reference config's keys in any case (``nf``, ``nframes``, ...)."""
    from pnp_vcve_torch.models.baselines import DenseMWNetMiniPSNR

    lower = {k.lower(): v for k, v in kwargs.items()}
    with torch.device("meta"):
        model = DenseMWNetMiniPSNR(**_known(lower, (
            "in_nc", "out_nc", "nf", "nb", "nframes", "front_rbs", "gc")))
    return _seeded(model, device, seed)


@BACKBONES.register(name="MFQEv2")
def _build_mfqev2(*, device, seed: int = 0, **kwargs):
    from pnp_vcve_torch.models.baselines import MFQEv2

    with torch.device("meta"):
        model = MFQEv2(**_known(kwargs, ("in_channels", "out_channels", "nf")))
    return _seeded(model, device, seed)


@BACKBONES.register(name="BasicVSRPlusPlus")
def _build_bvpp_vanilla(*, device, seed: int = 0, **kwargs):
    """Vanilla BasicVSR++ (reference basicvsr_pp.py:17-383), the downstream
    VSR of the ``--cascade`` mode."""
    from pnp_vcve_torch.models.baselines import BasicVSRPlusPlus

    with torch.device("meta"):
        model = BasicVSRPlusPlus(**_known(kwargs, _BVPP_KEYS))
    return _seeded(model, device, seed)


@BACKBONES.register(name="BasicVSRPlusPlusPQF", aliases=("BasicVSRPlusPlus_PQF",))
def _build_bvpp_pqf(*, device, seed: int = 0, variant: str = "base", **kwargs):
    from pnp_vcve_torch.models.baselines import BasicVSRPlusPlusPQF

    with torch.device("meta"):
        model = BasicVSRPlusPlusPQF(variant=variant, **_known(kwargs, _BVPP_KEYS))
    return _seeded(model, device, seed)


# the variant family (reference basicvsr_pp_v2.py:395, 504, 630)
@BACKBONES.register(name="BasicVSRPlusPlusPQFv2", aliases=("BasicVSRPlusPlus_PQF_v2",))
def _build_bvpp_pqf_v2(**kwargs):
    return _build_bvpp_pqf(**{**kwargs, "variant": "v2"})


@BACKBONES.register(name="BasicVSRPlusPlusPQFv2WithBSkip",
                    aliases=("BasicVSRPlusPlus_PQF_v2_withB_skip",))
def _build_bvpp_pqf_v2_withb(**kwargs):
    return _build_bvpp_pqf(**{**kwargs, "variant": "v2_withB_skip"})


@BACKBONES.register(name="BasicVSRPlusPlusPQFv2OnlyBSkip",
                    aliases=("BasicVSRPlusPlus_PQF_v2_onlyB_skip",))
def _build_bvpp_pqf_v2_onlyb(**kwargs):
    return _build_bvpp_pqf(**{**kwargs, "variant": "v2_onlyB_skip"})


def build_generator(cfg: dict, *, device, seed: int = 0):
    """Generator on ``device``, randomly initialised from ``seed``."""
    return _build(BACKBONES, dict(cfg), "Queue A item 8", device=device, seed=seed)


@COMPONENTS.register(name="DCNGANDiscriminator",
                     aliases=("Discriminator_UNet", "NLayerDiscriminator"))
def _build_dcngan_disc(*, device, seed: int = 0, **kwargs):
    from pnp_vcve_torch.models.baselines import DCNGANDiscriminator

    with torch.device("meta"):
        model = DCNGANDiscriminator(**_known(kwargs, ("d",)))
    return _seeded(model, device, seed)


def build_discriminator(cfg: dict, *, device, seed: int = 0):
    """Discriminator on ``device``, randomly initialised from ``seed``."""
    return _build(COMPONENTS, dict(cfg), "Queue A item 8", device=device, seed=seed)


@MODELS.register(name="Restorer", aliases=("BasicVSR", "BasicRestorer"))
def _build_restorer(generator: dict, pixel_loss: Optional[dict] = None, test_cfg=None, *,
                    device, seed=0, **_train_cfg):
    test_cfg = dict(test_cfg or {"metrics": ["PSNR", "SSIM"], "crop_border": 0})
    pl = dict(pixel_loss or {})
    return Restorer(
        generator=build_generator(dict(generator), device=device, seed=seed),
        pixel_loss=pl.pop("type", "CharbonnierLoss"),
        loss_weight=pl.pop("loss_weight", 1.0),
        test_cfg=test_cfg,
    )


@MODELS.register(name="CenterFrameRestorer", aliases=("STDF", "MFQEv2Restorer", "DCNGAN", "WMGAN"))
def _build_center_restorer(generator: dict, pixel_loss: Optional[dict] = None, test_cfg=None, *,
                           device, seed=0, **_train_cfg):
    test_cfg = dict(test_cfg or {"metrics": ["PSNR", "SSIM"], "crop_border": 0})
    pl = dict(pixel_loss or {})
    return CenterFrameRestorer(
        generator=build_generator(dict(generator), device=device, seed=seed),
        pixel_loss=pl.pop("type", "CharbonnierLoss"),
        loss_weight=pl.pop("loss_weight", 1.0),
        test_cfg=test_cfg,
    )


def build_restorer(model_cfg: dict, test_cfg: Optional[dict] = None, *, device, seed: int = 0):
    cfg = dict(model_cfg)
    if test_cfg is not None:
        cfg["test_cfg"] = test_cfg
    return _build(MODELS, cfg, "Queue A item 8", device=device, seed=seed)


# ---- datasets ---------------------------------------------------------------------


def _pipeline(pipeline):
    """``(Compose or None, the dataset's knobs)`` from a config pipeline."""
    tf = Compose(pipeline) if pipeline else None
    return tf, (tf or Compose([])).loader_params()


def _train_dataset(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder,
                   clips, num_input_frames, scale, pipeline):
    tf, p = _pipeline(pipeline)
    return MixCompressTrainDataset(
        transforms=tf,
        lq_folder=lq_folder,
        gt_folder=gt_folder,
        cprs15_folder=cprs15_folder,
        cprs25_folder=cprs25_folder,
        cprs35_folder=cprs35_folder,
        qp_slice_file=p["qp_slice_file"],
        clips=clips,
        num_input_frames=num_input_frames,
        scale=scale,
        gt_patch_size=p["gt_patch_size"],
        filename_tmpl=p["filename_tmpl"],
        data_ratio=p["data_ratio"],
        interval_list=p["interval_list"],
        replace_qp_with_ipb=p["replace_qp_with_ipb"],
    )


@DATASETS.register(name="SRREDSMultipleGTMixCompressDataset")
def _build_reds_train(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder,
                      num_input_frames=15, scale=1, pipeline=None, val_partition="REDS4",
                      test_mode=False, **_ignored):
    """REDS training clips (100 frames each): the 270 minus the validation
    partition, or the partition itself in test mode."""
    if val_partition == "REDS4":
        val = REDS4_CLIPS
    elif val_partition == "official":
        val = tuple(f"{i:03d}" for i in range(240, 270))
    else:
        raise ValueError(f"Unknown val_partition {val_partition!r}")
    names = list(val) if test_mode else reds_train_clips(val)
    return _train_dataset(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder,
                          [ClipIndex(n, 100) for n in names], num_input_frames, scale, pipeline)


@DATASETS.register(name="DAVISMultipleGTMixCompressDataset")
def _build_davis_train(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder,
                       num_input_frames=15, scale=1, pipeline=None, test_mode=False,
                       **_ignored):
    """Every clip folder under ``lq_folder``, each taken as 20 frames long as
    the reference hardcodes (sr_dsvis_multiple_gt_compress_dataset.py:84)."""
    names = sorted(d.name for d in os.scandir(lq_folder) if d.is_dir())
    return _train_dataset(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder,
                          [ClipIndex(n, 20) for n in names], num_input_frames, scale, pipeline)


@DATASETS.register(name="BigMultipleGTMixCompressDataset")
def _build_big_train(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder,
                     num_input_frames=15, scale=1, pipeline=None, test_mode=False,
                     sequence_length=None, **_ignored):
    """The multi-dataset training mixture (reference sr_big_dataset.py:6-87):
    every folder argument is a dict keyed by dataset name, and so may the
    pipeline's ``qp_slice_file`` be (loading_ipb_mix.py:14-217). Each
    dataset is one source weighted by its clip count, so clips pool
    uniformly, as the reference concatenates its data_infos."""
    sequence_length = dict(sequence_length or {"HR": 100, "LR": 100, "DAVIS": 20})
    tf, p = _pipeline(pipeline)
    qp_files = p["qp_slice_file"]
    sources, weights = [], []
    for name in dict(lq_folder):
        root = lq_folder[name]
        names = sorted(d.name for d in os.scandir(root) if d.is_dir())
        clips = [ClipIndex(n, sequence_length.get(name, 100)) for n in names]
        sources.append(MixCompressTrainDataset(
            transforms=tf,
            lq_folder=root,
            gt_folder=gt_folder[name],
            cprs15_folder=cprs15_folder[name],
            cprs25_folder=cprs25_folder[name],
            cprs35_folder=cprs35_folder[name],
            qp_slice_file=qp_files.get(name) if isinstance(qp_files, dict) else qp_files,
            clips=clips,
            num_input_frames=num_input_frames,
            scale=scale,
            gt_patch_size=p["gt_patch_size"],
            filename_tmpl=p["filename_tmpl"],
            data_ratio=p["data_ratio"],
            interval_list=p["interval_list"],
            replace_qp_with_ipb=p["replace_qp_with_ipb"],
        ))
        weights.append(len(clips))
    return WeightedMixture(sources, weights)


def _vimeo_keys(ann_file: str) -> list[str]:
    """Annotation lines '00001/0266 (256,448,3)' -> keys (reference
    sr_vimeo90k_multiple_gt_compress_dataset.py:66-67)."""
    with open(ann_file) as fin:
        return [line.strip().split(" ")[0] for line in fin if line.strip()]


@DATASETS.register(name="SRVimeo90KMultipleGTMixCompressDataset")
def _build_vimeo_mix(cprs_all_folder, lq_folder, gt_folder, ann_file, pipeline=None, scale=1,
                     num_input_frames=7, test_mode=False, _bd_prefix="", **_ignored):
    """Vimeo-90k mixture training source (reference
    sr_vimeo90k_multiple_gt_compress_dataset.py:92-181): the uncompressed
    frames under ``lq_folder/png``, the compressed ones under
    ``cprs_all_folder/{prefix}crf{15,25,35}/png``."""
    _, p = _pipeline(pipeline)
    return VimeoMixDataset(
        lq_folder=os.path.join(lq_folder, "png"),
        gt_folder=gt_folder,
        cprs15_folder=os.path.join(cprs_all_folder, f"{_bd_prefix}crf15", "png"),
        cprs25_folder=os.path.join(cprs_all_folder, f"{_bd_prefix}crf25", "png"),
        cprs35_folder=os.path.join(cprs_all_folder, f"{_bd_prefix}crf35", "png"),
        qp_slice_file=p["qp_slice_file"],
        clips=_vimeo_keys(ann_file),
        num_input_frames=num_input_frames,
        scale=scale,
        gt_patch_size=p["gt_patch_size"],
        data_ratio=p["data_ratio"],
        replace_qp_with_ipb=p["replace_qp_with_ipb"],
    )


@DATASETS.register(name="SRVimeo90KMultipleGTMixCompressDataset_BD")
def _build_vimeo_mix_bd(**kwargs):
    """The blur-downsampled form: compressed folders ``BD_crf{15,25,35}/png``
    (reference sr_vimeo90k_multiple_gt_compress_dataset.py:183-225)."""
    return _build_vimeo_mix(_bd_prefix="BD_", **kwargs)


@DATASETS.register(name="SRVimeo90KMultipleGTCompressDataset")
def _build_vimeo_test(cprs_folder, gt_folder, ann_file, lq_folder=None, pipeline=None, scale=1,
                      num_input_frames=7, test_mode=True, **_ignored):
    """Vimeo-90k whole-septuplet test source (reference
    sr_vimeo90k_multiple_gt_compress_dataset.py:10-89)."""
    _, p = _pipeline(pipeline)
    return VimeoTestDataset(
        cprs_folder=cprs_folder,
        gt_folder=gt_folder,
        qp_slice_file=p["qp_slice_file"],
        clips=_vimeo_keys(ann_file),
        num_input_frames=num_input_frames,
        scale=scale,
        replace_qp_with_ipb=p["replace_qp_with_ipb"],
    )


@DATASETS.register(name="KITTIMultipleGTMixCompressDataset", aliases=("WMGANDataset_test_kitti",))
def _build_kitti_pairs(lq_folder, gt_folder, pipeline=None, scale=1, test_mode=True, **_ignored):
    """KITTI's fixed (10, 11) frame pairs (reference
    sr_kitti_multiple_gt_compress_dataset.py:6-150, augmentation.py:1549-1604)."""
    _, p = _pipeline(pipeline)
    return KittiPairDataset(lq_folder=lq_folder, gt_folder=gt_folder,
                            qp_slice_file=p["qp_slice_file"])


def _ldp(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder, centers,
         pipeline=None, scale=1, sequence_length=100):
    """Every clip folder under ``lq_folder``, each ``sequence_length`` frames
    long (JAX builder :905-945)."""
    from pnp_vcve_torch.data.ldp import LDPTripleDataset

    names = sorted(d.name for d in os.scandir(lq_folder) if d.is_dir())
    _, p = _pipeline(pipeline)
    return LDPTripleDataset(
        lq_folder=lq_folder,
        gt_folder=gt_folder,
        cprs15_folder=cprs15_folder,
        cprs25_folder=cprs25_folder,
        cprs35_folder=cprs35_folder,
        qp_slice_file=p["qp_slice_file"],
        clips=[ClipIndex(n, sequence_length) for n in names],
        centers=centers,
        scale=scale,
        gt_patch_size=p["gt_patch_size"],
        filename_tmpl=p["filename_tmpl"],
        data_ratio=p["data_ratio"],
    )


@DATASETS.register(name="LDPPQFDataset")
def _build_ldp_pqf(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder,
                   pipeline=None, scale=1, test_mode=False, centers="pqf", sequence_length=100,
                   **_ignored):
    """(left PQF, PQF, right PQF) triples of the MFQE protocol (reference
    ldp_dataset.py:11-245)."""
    return _ldp(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder, centers,
                pipeline, scale, sequence_length)


@DATASETS.register(name="LDPNonPQFDataset")
def _build_ldp_nonpqf(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder,
                      pipeline=None, scale=1, test_mode=False, centers="nonpqf",
                      sequence_length=100, **_ignored):
    """The same triples centred on the non-PQF (B) frames."""
    return _ldp(lq_folder, gt_folder, cprs15_folder, cprs25_folder, cprs35_folder, centers,
                pipeline, scale, sequence_length)


def _test_dataset(lq_folder, gt_folder, clips, num_input_frames, scale, pipeline):
    tf, p = _pipeline(pipeline)
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
    names = sorted(d.name for d in os.scandir(lq_folder) if d.is_dir())
    clips = [
        ClipIndex(n, sum(1 for f in os.scandir(os.path.join(lq_folder, n))
                         if f.name.endswith(".png")))
        for n in names
    ]
    return _test_dataset(lq_folder, gt_folder, clips, num_input_frames, scale, pipeline)


def build_dataset(cfg: dict):
    """One dataset. ``RepeatDataset`` is unwrapped: the sampler is endless,
    and the reference's x1000 exists only for its epoch-based loader
    (dataset_wrappers.py:5-39)."""
    cfg = dict(cfg)
    if cfg.get("type") == "RepeatDataset":
        return build_dataset(dict(cfg["dataset"]))
    return _build(DATASETS, cfg, "Queue A item 8")


def build_train_datasets(cfg_list):
    if isinstance(cfg_list, dict):
        cfg_list = [cfg_list]
    return [build_dataset(c) for c in cfg_list]


# ---- optimizer ------------------------------------------------------------------------


def build_optimizer(cfg: dict, model: torch.nn.Module, lr_config: Optional[dict] = None,
                    total_iters: int = 300_000):
    """``(torch.optim.Adam, LambdaLR)`` from the config's optimizer and
    lr_config dicts (configs/HR_davis_LR_128x128.py:19-28): optax's Adam
    (eps 1e-8 outside the square root, as torch's) with the config's betas,
    under the cosine-restart schedule (or a constant rate).

    ``paramwise_cfg.custom_keys`` (reference mmedit/core/optimizer/
    builder.py:5-58, e.g. ``{'spynet': dict(lr_mult=0.125)}``) scales the
    rate of every parameter whose name contains the key (the last matching
    key wins, as in the JAX builder); each multiplier is a parameter group.
    """
    opt = dict(cfg.get("generator", cfg))
    typ = opt.pop("type", "Adam")
    lr = opt.pop("lr", 2e-4)
    betas = tuple(opt.pop("betas", (0.9, 0.999)))
    custom_keys = dict(dict(opt.pop("paramwise_cfg", None) or {}).get("custom_keys", {}) or {})
    if typ != "Adam":
        raise NotImplementedError(f"optimizer {typ!r}")

    groups: dict[float, list] = {}
    for name, p in model.named_parameters():
        mult = 1.0
        for key, kcfg in custom_keys.items():
            if key in name:
                mult = float(dict(kcfg).get("lr_mult", 1.0))
        groups.setdefault(mult, []).append(p)
    optimizer = torch.optim.Adam(
        [{"params": ps, "lr": lr * mult} for mult, ps in groups.items()],
        lr=lr, betas=betas, eps=1e-8,
    )

    if lr_config is not None and lr_config.get("policy") == "CosineRestart":
        schedule = cosine_restart_schedule(
            lr,
            lr_config.get("periods", [total_iters]),
            lr_config.get("restart_weights", [1.0]),
            lr_config.get("min_lr", 0.0),
        )
        factor = lambda step: schedule(step) / lr  # noqa: E731
    else:
        factor = lambda step: 1.0  # noqa: E731
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
