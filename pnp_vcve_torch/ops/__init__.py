"""Plain PyTorch ops (counterparts of pnp_vcve_tpu/ops)."""
