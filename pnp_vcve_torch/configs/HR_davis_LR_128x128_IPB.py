"""IPB variant for the PyTorch/CUDA port: the CAA's QP input is replaced by
the slice-type ordinal (configs/HR_davis_LR_128x128_IPB.py, the reference's
configs/HR_davis_LR_128x128_IPB.py): the flagship training config with
``replace_qp_withIPB=True`` on every codec-prior loader."""

from pnp_vcve_torch.core.presets import flagship_data

_base_ = ["./HR_davis_LR_128x128.py"]

exp_name = "HR_davis_LR_128x128_IPB"
work_dir = f"./work_dirs/{exp_name}"

data = flagship_data(replace_qp_withIPB=True)
