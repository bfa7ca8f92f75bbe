"""The eval's multi-device and multi-process modes (counterpart of
pnp_vcve_tpu/parallel/): the exact two-sweep pipeline over a list of
devices (:mod:`.seqpar`) and the rank-strided clip shards with their
count-weighted metric reduction (:mod:`.multihost`)."""
