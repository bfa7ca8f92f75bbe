"""Training and evaluation (counterparts of pnp_vcve_tpu/train): losses, the
schedule, the train state, the train and eval steps, the loop, the
evaluation harness."""
