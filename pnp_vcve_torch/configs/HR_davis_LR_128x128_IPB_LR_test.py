"""IPB variant pointed at the REDS LR (X4) test set, the pre-enhancement
that feeds a downstream VSR model (configs/HR_davis_LR_128x128_IPB_LR_test.py,
the reference's configs/HR_davis_LR_128x128_IPB_LR_test.py), for the
PyTorch/CUDA port."""

from pnp_vcve_torch.core.presets import flagship_data

_base_ = ["./HR_davis_LR_128x128_IPB.py"]

exp_name = "HR_davis_LR_128x128_IPB_LR_test"
work_dir = f"./work_dirs/{exp_name}"

data = flagship_data(
    replace_qp_withIPB=True,
    test_lq="dataset/REDS_test_LR/crf15/png",
    test_gt="dataset/REDS_test_LR/X4/png",
    test_qp_json="dataset/REDS_test_LR/multi_cprs_REDS_test_LR.json",
)
