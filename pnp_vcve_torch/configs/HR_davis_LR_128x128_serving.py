"""Flagship serving config for the PyTorch/CUDA port: the weights and
architecture of HR_davis_LR_128x128.py with the serving knobs of
configs/HR_davis_LR_128x128_serving_tpu.py.

On the port every CUDA tensor runs the hand-written kernels whatever
``use_pallas_kernels`` says, and the warp kernel is exact for any flow, so
``warp_impl='pf'`` changes nothing in the forward. The train step refuses
this config, as the JAX package's does: ``pf`` and ``block8`` are serving
settings.
"""

_base_ = ["./HR_davis_LR_128x128.py"]

exp_name = "HR_davis_LR_128x128_serving"

model = dict(generator=dict(use_pallas_kernels=True, warp_impl="pf"))

work_dir = f"./work_dirs/{exp_name}"
