from .build import get_model
from .ghiasi import Ghiasi
from .krn import KeypointRegressionNet, krn_loss
from .spn import SpacecraftPoseNet, spn_loss

__all__ = ["get_model", "Ghiasi", "KeypointRegressionNet", "krn_loss", "SpacecraftPoseNet",
           "spn_loss"]
