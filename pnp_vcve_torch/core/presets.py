"""Config presets for the flagship configurations (counterpart of
pnp_vcve_tpu/core/presets.py). Config files call these helpers; every dict
key keeps the reference's name, so ``--cfg-options`` paths carry over."""

from __future__ import annotations

__all__ = ["flagship_model", "mix_pipeline", "train_dataset", "flagship_data"]

COMPRESS_DATA_RATIO = [0.2, 0.6, 0.85, 1]


def flagship_model(**overrides):
    gen = dict(
        type="IconVSR_restore_wo_refill_mv_ipb_fast_domain_dynamic_with_par",
        mid_channels=64,
        num_blocks=8,
        padding=3,
        with_cat=True,
        use_base_qp=True,
        num_experts=6,
        expert_softmax=True,
        init_weight=True,
        with_bias=True,
        with_se=True,
        with_par=True,
        one_layer=True,
        blocktype="drt",
        channel_first=True,
        sparse_val=False,
        align_key=True,
        vsr=False,
    )
    gen.update(overrides)
    return dict(
        type="BasicVSR",
        generator=gen,
        pixel_loss=dict(type="CharbonnierLoss", loss_weight=1.0, reduction="mean"),
    )


def mix_pipeline(qp_slice_file, filename_tmpl="{:08d}.png", replace_qp_withIPB=False):
    return [
        dict(type="GenerateSegmentIndices_Mix_Compress", interval_list=[1],
             filename_tmpl=filename_tmpl),
        # reference configs ship this at ratio 0 (HR_davis_LR_128x128.py:52)
        dict(type="TemporalReverse", keys="lq_path", reverse_ratio=0),
        dict(
            type="LoadImageFromFileList_Mix_Compress_ipb",
            key="lq",
            channel_order="rgb",
            random_compress=True,
            load_mv=True,
            load_qp_slice=True,
            load_base_qp=True,
            load_partition=True,
            drconv=True,
            qp_slice_file=qp_slice_file,
            data_ratio=COMPRESS_DATA_RATIO,
            replace_qp_withIPB=replace_qp_withIPB,
        ),
        dict(type="LoadImageFromFileList", key="gt", channel_order="rgb"),
        dict(type="RescaleToZeroOne", keys=["lq", "gt", "base_QPs", "QPs", "partitions"]),
        dict(type="PairedRandomCrop_mv", gt_patch_size=128),
        dict(type="Flip", keys=["lq", "gt", "mvs", "partitions"], flip_ratio=0.5,
             direction="horizontal"),
        dict(type="Flip", keys=["lq", "gt", "mvs", "partitions"], flip_ratio=0.5,
             direction="vertical"),
        dict(type="RandomTransposeHW", keys=["lq", "gt", "mvs", "partitions"],
             transpose_ratio=0.5),
        dict(type="FramesToTensor",
             keys=["lq", "gt", "mvs", "slices", "base_QPs", "QPs", "partitions"]),
        dict(type="Collect", keys=["lq", "gt", "mvs", "slices", "base_QPs", "QPs", "partitions"]),
    ]


def train_dataset(dataset_type, root, gt_sub, qp_json, filename_tmpl="{:08d}.png",
                  replace_qp_withIPB=False, **extra):
    return dict(
        type="RepeatDataset",
        times=1000,
        dataset=dict(
            type=dataset_type,
            lq_folder=f"{root}/crf15/png",
            cprs15_folder=f"{root}/crf15/png",
            cprs25_folder=f"{root}/crf25/png",
            cprs35_folder=f"{root}/crf35/png",
            gt_folder=f"{root}/{gt_sub}/png",
            num_input_frames=15,
            pipeline=mix_pipeline(qp_json, filename_tmpl, replace_qp_withIPB),
            scale=1,
            test_mode=False,
            **extra,
        ),
    )


def flagship_data(
    replace_qp_withIPB=False,
    test_lq="dataset/REDS_test_HR/crf35/png",
    test_gt="dataset/REDS_test_HR/X4/png",
    test_qp_json="dataset/REDS_test_HR/multi_cprs_REDS_test_HR.json",
):
    test_pipeline = [
        dict(type="GenerateSegmentIndices_LR", interval_list=[1]),
        dict(
            type="LoadImageFromFileList_ipb",
            key="lq",
            channel_order="rgb",
            random_compress=False,
            load_mv=True,
            load_qp_slice=True,
            load_base_qp=True,
            load_partition=True,
            drconv=True,
            qp_slice_file=test_qp_json,
            replace_qp_withIPB=replace_qp_withIPB,
        ),
        dict(type="LoadImageFromFileList", key="gt", channel_order="rgb"),
        dict(type="RescaleToZeroOne", keys=["lq", "gt", "base_QPs", "QPs", "partitions"]),
    ]
    eval_set = dict(
        type="SRREDSMultipleGTCompressDataset",
        lq_folder=test_lq,
        gt_folder=test_gt,
        num_input_frames=100,
        pipeline=test_pipeline,
        scale=1,
        val_partition="REDS4",
        test_mode=True,
    )
    return dict(
        workers_per_gpu=6,
        train_dataloader=dict(samples_per_gpu=5, drop_last=True, mix_data=True,
                              weights=[1, 2, 1], replacement=False),
        val_dataloader=dict(samples_per_gpu=1),
        test_dataloader=dict(samples_per_gpu=1, workers_per_gpu=1),
        train=[
            train_dataset(
                "SRREDSMultipleGTMixCompressDataset", "dataset/REDS_train_HR",
                "sharp", "dataset/REDS_train_HR/REDS_train_HR.json",
                replace_qp_withIPB=replace_qp_withIPB, val_partition="REDS4",
            ),
            train_dataset(
                "SRREDSMultipleGTMixCompressDataset", "dataset/REDS_train_LR",
                "X4", "dataset/REDS_train_LR/REDS_train_LR.json",
                replace_qp_withIPB=replace_qp_withIPB, val_partition="REDS4",
            ),
            train_dataset(
                "DAVISMultipleGTMixCompressDataset", "dataset/davis_all",
                "sharp", "dataset/davis_all/train_2017_QP_slice_all.json",
                filename_tmpl="{:05d}.png", replace_qp_withIPB=replace_qp_withIPB,
            ),
        ],
        val=eval_set,
        test=dict(eval_set),
    )
