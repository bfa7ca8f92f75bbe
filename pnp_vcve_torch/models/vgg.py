"""VGG features for the perceptual loss (counterpart of
pnp_vcve_tpu/models/vgg.py; reference ``PerceptualVGG``,
mmedit/models/losses/perceptual_loss.py:12-94).

:class:`VGGFeatures` is torchvision's VGG16 / VGG19 ``features`` stack
under its names (``features.{i}.weight`` / ``.bias`` at torchvision's layer
indices), so a torchvision ``vgg*.pth`` state dict loads as it is
(:func:`load_torchvision_vgg` drops its ``classifier.*``). No weights ship
with the repository and none are fetched: ``reset_parameters`` draws
He-normal weights and zero biases from a seed, as JAX's ``init_vgg_params``
does, for tests and plumbing. :func:`vgg_features` returns the maps of
NHWC [0, 1] images, ImageNet-normalised first, at the requested layer
indices (strings, as the reference keys them). Plain PyTorch (cuDNN
convolutions), as JAX computes it in XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["VGG_CONFIGS", "VGGFeatures", "vgg_features", "load_torchvision_vgg"]

# torchvision's ``features`` sequences: channels per conv, 'M' a 2x2 max pool
VGG_CONFIGS = {
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}
# ImageNet statistics (perceptual_loss.py:53-60)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class VGGFeatures(nn.Module):
    """torchvision's ``features`` stack: Conv2d(3x3, pad 1) + ReLU, and
    MaxPool2d(2) at each 'M'."""

    def __init__(self, vgg_type: str = "vgg19"):
        super().__init__()
        layers, cin = [], 3
        for v in VGG_CONFIGS[vgg_type]:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, 1, 1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def reset_parameters(self, generator: torch.Generator):
        """He-normal weights (std sqrt(2 / fan_in)), zero biases."""
        with torch.no_grad():
            for m in self.features:
                if isinstance(m, nn.Conv2d):
                    std = math.sqrt(2.0 / m.weight[0].numel())
                    m.weight.copy_(torch.empty(m.weight.shape).normal_(0.0, std,
                                                                       generator=generator))
                    m.bias.zero_()


def load_torchvision_vgg(model: VGGFeatures, state_dict: Mapping[str, torch.Tensor]):
    """Load a torchvision VGG state dict's ``features.*`` (its ``classifier.*``
    dropped) into ``model``."""
    model.load_state_dict({k: v for k, v in state_dict.items() if k.startswith("features.")},
                          strict=True)
    return model


def vgg_features(model: VGGFeatures, x: torch.Tensor,
                 layer_names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The maps of ``x (b, h, w, 3)`` in [0, 1], ImageNet-normalised, after
    each layer index in ``layer_names`` (strings), NHWC; the stack runs to
    the deepest one."""
    wanted = {str(n) for n in layer_names}
    last = max(int(n) for n in wanted)
    mean = torch.tensor(_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_STD, dtype=x.dtype, device=x.device)
    y = ((x - mean) / std).permute(0, 3, 1, 2)
    out = {}
    for idx, layer in enumerate(model.features[:last + 1]):
        if isinstance(layer, nn.Conv2d):
            y = F.conv2d(y, layer.weight.to(y.dtype), layer.bias.to(y.dtype), padding=1)
        elif isinstance(layer, nn.ReLU):
            y = F.relu(y)
        else:
            y = F.max_pool2d(y, 2, 2)
        if str(idx) in wanted:
            out[str(idx)] = y.permute(0, 2, 3, 1)
    return out
