"""DeblurGANv2's generators in their plain layout (FPN-MobileNet,
FPN-Inception; the extra ones: ResNet, FPN-Inception-Simple, FPN-Dense,
UNet-SEResNeXt) and its discriminators."""

from .fpn_inception import FPNInception
from .fpn_mobilenet import FPNMobileNet
from .norms import load_checkpoint
