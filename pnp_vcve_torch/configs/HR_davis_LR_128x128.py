"""Flagship PnP-VCVE training config for the PyTorch/CUDA port.

The same settings as configs/HR_davis_LR_128x128.py (the reference's
configs/HR_davis_LR_128x128.py): model hyper-parameters, the 1:2:1 mixture
of three training sets, the CRF mixture ratios, Adam and the cosine-restart
schedule. Keys keep the reference's names so ``--cfg-options`` paths carry
over. ``remat`` (default True) recomputes each sweep step in the backward.
"""

from pnp_vcve_torch.core.presets import flagship_data, flagship_model

exp_name = "HR_davis_LR_128x128"

model = flagship_model()
train_cfg = dict(fix_iter=5000)
test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=0)

data = flagship_data()

optimizers = dict(generator=dict(type="Adam", lr=2e-4, betas=(0.9, 0.99)))

total_iters = 300000
lr_config = dict(
    policy="CosineRestart",
    by_epoch=False,
    periods=[300000],
    restart_weights=[1],
    min_lr=1e-7,
)

checkpoint_config = dict(interval=2000, save_optimizer=True, by_epoch=False)
evaluation = dict(interval=5000, save_image=False)
log_config = dict(interval=100)
log_level = "INFO"
work_dir = f"./work_dirs/{exp_name}"
load_from = None
resume_from = None
