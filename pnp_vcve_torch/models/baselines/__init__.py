"""Baseline models of the paper's comparisons (counterpart of
pnp_vcve_tpu/models/baselines): BasicVSR++ and its PQF family, MFQEv2, and
the centre-frame baselines STDF, DCNGAN (with its discriminator), MW-GAN's
PSNR generator and SIDECVSR."""

from .basicvsr_pp import BasicVSRPlusPlus, BasicVSRPlusPlusPQF
from .dcngan import DCNGANDiscriminator, DCNGANNet
from .mfqev2 import MFQEv2, mfqe_joint_enhance
from .mwgan import DenseMWNetMiniPSNR
from .sidecvsr import SIDECVSR
from .stdf import STDFNet

__all__ = ["BasicVSRPlusPlus", "BasicVSRPlusPlusPQF", "MFQEv2", "mfqe_joint_enhance",
           "STDFNet", "DCNGANNet", "DCNGANDiscriminator", "DenseMWNetMiniPSNR", "SIDECVSR"]
