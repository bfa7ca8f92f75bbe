"""Model modules (counterparts of pnp_vcve_tpu/models)."""
