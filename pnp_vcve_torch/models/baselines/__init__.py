"""Baseline models of the paper's comparisons (counterpart of
pnp_vcve_tpu/models/baselines): BasicVSR++ and its PQF family, MFQEv2."""

from .basicvsr_pp import BasicVSRPlusPlus, BasicVSRPlusPlusPQF
from .mfqev2 import MFQEv2, mfqe_joint_enhance

__all__ = ["BasicVSRPlusPlus", "BasicVSRPlusPlusPQF", "MFQEv2", "mfqe_joint_enhance"]
