"""Logging and the environment report (counterpart of pnp_vcve_tpu/utils)."""
