from .ghiasi import Ghiasi
from .krn import KeypointRegressionNet, krn_loss

__all__ = ["Ghiasi", "KeypointRegressionNet", "krn_loss"]
