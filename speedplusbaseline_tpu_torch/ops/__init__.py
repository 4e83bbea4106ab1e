"""Hand-written CUDA kernels of the Ghiasi generator, each beside its plain
PyTorch version. Importing this package loads no CUDA and builds nothing:
a kernel is built at its first launch (see ``_build``)."""
from .edgeconv import reflect_conv9x9, reflect_conv9x9_plain
from .instancenorm import instance_norm_film, instance_norm_film_plain
from .midconv import reflect_conv3x3, reflect_conv3x3_plain
from .resblock import ghiasi_resblock, ghiasi_resblock_plain

__all__ = ["instance_norm_film", "instance_norm_film_plain", "ghiasi_resblock",
           "ghiasi_resblock_plain", "reflect_conv9x9", "reflect_conv9x9_plain",
           "reflect_conv3x3", "reflect_conv3x3_plain"]
