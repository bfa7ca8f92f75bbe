"""Flagship serving config for the PyTorch/CUDA port: the weights and
architecture of HR_davis_LR_128x128.py with the serving knobs of
configs/HR_davis_LR_128x128_serving_tpu.py.

``warp_impl='pf'`` computes what the JAX package's serving pipeline
computes: each 8x8 block's motion vector, read at the block's top-left
pixel and clamped to +-16 px, warps the keyframe carry (K1b), and the last
DRT block of every step also writes the keyframe carry (K3s). It needs
``use_pallas_kernels``, 64 channels and frames whose sides are multiples of
16, as in JAX. Exact for the 8x8-block-constant MV maps the rasterizer
emits with |MV| <= 16 px; the train step refuses this config, as the JAX
package's does.
"""

_base_ = ["./HR_davis_LR_128x128.py"]

exp_name = "HR_davis_LR_128x128_serving"

model = dict(generator=dict(use_pallas_kernels=True, warp_impl="pf"))

work_dir = f"./work_dirs/{exp_name}"
