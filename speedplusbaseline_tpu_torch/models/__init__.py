from .build import get_model
from .ghiasi import Ghiasi
from .krn import KeypointRegressionNet, krn_loss
from .revgrad import DomainClassifier, RevGrad, bce_with_logits, grad_reverse
from .spn import SpacecraftPoseNet, spn_loss

__all__ = ["get_model", "Ghiasi", "KeypointRegressionNet", "krn_loss", "DomainClassifier",
           "RevGrad", "bce_with_logits", "grad_reverse", "SpacecraftPoseNet", "spn_loss"]
