"""pnp_vcve_torch — the PyTorch/CUDA port of pnp_vcve_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module names:

ops       plain PyTorch warp and dynamic (MoE) conv
kernels   hand-written CUDA kernels for sm_90a, their wrappers and plain versions
models    CAA predictors, BAE blocks, the PnPVCVE generator, the restorer
core      builder (config -> objects), checkpoint I/O, JAX weight conversion
train     the eval step and the evaluation harness

Host code without JAX (configs, registry, presets, data, metrics) is shared
with ``pnp_vcve_tpu``.
"""

__version__ = "0.1.0"
