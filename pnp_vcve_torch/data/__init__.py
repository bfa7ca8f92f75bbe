"""Host-side data: the config pipelines, the clip datasets, the MV
rasterizer and the prefetching loader (counterparts of pnp_vcve_tpu/data)."""
