"""Eval step and evaluation harness (counterparts of pnp_vcve_tpu/train)."""
