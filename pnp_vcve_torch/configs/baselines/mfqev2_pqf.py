"""MFQEv2 PQF-enhancer training (stage 1 of the two-model MFQE protocol).

Reference recipe: MFQEv2Restorer + LDPPQFDataset (mmedit/models/restorers/
mfqev2_restorer.py, mmedit/datasets/ldp_dataset.py:11-131): the PQF model
trains on (left-PQF, PQF, right-PQF) triples with the center ground truth;
SPyNet frozen for fix_spynet_iter then fine-tuned at lr_mult=0.125.
The sibling config mfqev2_nonpqf.py trains the non-PQF model.

The PyTorch port's copy of configs/baselines/mfqev2_pqf.py. The port builds
its model and evaluates it (tools/torch_test.py); its training keys
(``train_cfg``, ``paramwise_cfg``) are carried as data, and training it
waits for ROADMAP Queue A item 8.
"""

exp_name = "mfqev2_pqf"

model = dict(
    type="MFQEv2Restorer",
    generator=dict(type="MFQEv2", in_channels=3, out_channels=3, nf=32),
    pixel_loss=dict(type="CharbonnierLoss", loss_weight=1.0),
)
train_cfg = dict(fix_spynet_iter=5000, freeze_prefixes=("spynet",))
test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=0)

_root = "dataset/REDS_train_HR"
_pipeline = [
    dict(
        type="LoadImageFromFileList_Mix_Compress_ipb", key="lq",
        channel_order="rgb", qp_slice_file=f"{_root}/REDS_train_HR.json",
        data_ratio=[0.2, 0.6, 0.85, 1.0],
    ),
    dict(type="PairedRandomCrop_mv", gt_patch_size=128),
]
data = dict(
    workers_per_gpu=6,
    train_dataloader=dict(samples_per_gpu=8, drop_last=True),
    train=[dict(
        type="LDPPQFDataset",
        lq_folder=f"{_root}/crf15/png",
        gt_folder=f"{_root}/sharp/png",
        cprs15_folder=f"{_root}/crf15/png",
        cprs25_folder=f"{_root}/crf25/png",
        cprs35_folder=f"{_root}/crf35/png",
        sequence_length=100,
        pipeline=_pipeline,
        scale=1,
    )],
)

optimizers = dict(generator=dict(
    type="Adam", lr=1e-4, betas=(0.9, 0.999),
    paramwise_cfg=dict(custom_keys={"spynet": dict(lr_mult=0.125)}),
))
lr_config = dict(policy="CosineRestart", periods=[300000], restart_weights=[1], min_lr=1e-7)
total_iters = 300000
checkpoint_config = dict(interval=5000, save_optimizer=True, by_epoch=False)
evaluation = dict(interval=0)
log_config = dict(interval=100)
mesh = dict(sp=1)
