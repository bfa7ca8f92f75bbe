"""Baseline models of the paper's comparisons (counterpart of
pnp_vcve_tpu/models/baselines): BasicVSR++ and its PQF family, MFQEv2, the
centre-frame baselines STDF, DCNGAN (with its discriminator), MW-GAN's
PSNR generator and SIDECVSR, and the super-resolution zoo downstream of the
enhancer: BasicVSR, IconVSR, EDVR, TDAN, TOFlow, RealBasicVSR and the
single-image models EDSR, RRDBNet, MSRResNet, SRCNN and RDN."""

from .basicvsr import BasicVSRNet, IconVSRNet
from .basicvsr_pp import BasicVSRPlusPlus, BasicVSRPlusPlusPQF
from .dcngan import DCNGANDiscriminator, DCNGANNet
from .edvr import EDVRFeatureExtractor, EDVRNet
from .mfqev2 import MFQEv2, mfqe_joint_enhance
from .mwgan import DenseMWNetMiniPSNR
from .sidecvsr import SIDECVSR
from .sisr import EDSR, RDN, SRCNN, MSRResNet, RRDBNet
from .stdf import STDFNet
from .tdan import TDANNet
from .tof import RealBasicVSRNet, TOFlow

__all__ = ["BasicVSRPlusPlus", "BasicVSRPlusPlusPQF", "MFQEv2", "mfqe_joint_enhance",
           "STDFNet", "DCNGANNet", "DCNGANDiscriminator", "DenseMWNetMiniPSNR", "SIDECVSR",
           "BasicVSRNet", "IconVSRNet", "EDVRNet", "EDVRFeatureExtractor", "TDANNet", "TOFlow",
           "RealBasicVSRNet", "EDSR", "RRDBNet", "MSRResNet", "SRCNN", "RDN"]
