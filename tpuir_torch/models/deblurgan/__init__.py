"""DeblurGANv2's FPN generators (MobileNet, Inception) in their plain layout."""

from .fpn_inception import FPNInception
from .fpn_mobilenet import FPNMobileNet
from .norms import load_checkpoint
