"""pnp_vcve_torch — the PyTorch/CUDA port of pnp_vcve_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module names:

ops       plain PyTorch warp and dynamic (MoE) conv
kernels   hand-written CUDA kernels for sm_90a, their wrappers, their autograd
          Functions and plain versions
models    CAA predictors, BAE blocks, the PnPVCVE generator, the restorer
core      config files, registry, presets, builder (config -> objects),
          checkpoint I/O, JAX weight conversion
data      pipelines, clip datasets, MV rasterizer, prefetching loader
metrics   PSNR, SSIM, MAE, NIQE
train     losses, schedule, train state, train and eval steps, loop, evaluation
serving   the batch-of-streams scheduler and its one-card batched executor
apis      one-call inference helpers (init_model, restoration_*_inference)
configs   the flagship training and serving configs

The package and its entry points (``tools/torch_*.py``: test, train, the
serving curve, the servable packager, the HTTP handler) import neither JAX
nor ``pnp_vcve_tpu``: what they need of the JAX package's host code is
copied here.
"""

__version__ = "0.1.0"
