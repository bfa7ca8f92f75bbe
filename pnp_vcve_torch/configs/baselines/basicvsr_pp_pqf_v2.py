"""BasicVSR++ PQF v2 training on the compressed-mixture protocol
(reference basicvsr_pp_v2.py:395 + configs analog).

The PyTorch port's copy of configs/baselines/basicvsr_pp_pqf_v2.py. The port builds
its model and evaluates it (tools/torch_test.py); its training keys
(``train_cfg``, ``paramwise_cfg``) are carried as data, and training it
waits for ROADMAP Queue A item 8.
"""

from pnp_vcve_torch.core.presets import flagship_data

exp_name = "basicvsr_pp_pqf_v2"

model = dict(
    type="BasicVSR",
    generator=dict(
        type="BasicVSRPlusPlus_PQF_v2", mid_channels=64, num_blocks=7,
        is_low_res_input=False, max_residue_magnitude=10,
    ),
    pixel_loss=dict(type="CharbonnierLoss", loss_weight=1.0),
)
train_cfg = dict(fix_iter=5000, freeze_prefixes=("spynet",))
test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=0)

data = flagship_data()

optimizers = dict(generator=dict(
    type="Adam", lr=1e-4, betas=(0.9, 0.99),
    paramwise_cfg=dict(custom_keys={"spynet": dict(lr_mult=0.25)}),
))
lr_config = dict(policy="CosineRestart", periods=[300000], restart_weights=[1], min_lr=1e-7)
total_iters = 300000
checkpoint_config = dict(interval=5000, save_optimizer=True, by_epoch=False)
evaluation = dict(interval=5000, save_image=False)
log_config = dict(interval=100)
mesh = dict(sp=1)
