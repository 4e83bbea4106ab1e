"""Visualization debug helpers (counterpart of ``speedplusbaseline_tpu/
io_utils/visualize.py``; reference src/utils/visualize.py:33-95).

The same three helpers (imshow, plot_2D_bbox, scatter_keypoints) on an
image in [0, 1], HWC or CHW, as a numpy array or a tensor on any device.
They draw on matplotlib's Agg backend, so they work headless, and return
the figure; ``show=True`` also shows it.
"""
from __future__ import annotations

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _to_numpy_image(image):
    img = _numpy(image)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = np.transpose(img, (1, 2, 0))  # CHW -> HWC
    return np.clip(img, 0.0, 1.0)


def _pyplot():
    import matplotlib

    if matplotlib.get_backend().lower() not in ("agg",
                                                "module://matplotlib_inline.backend_inline"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def imshow(image, show: bool = False):
    """Display an image (visualize.py:33-43)."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    ax.imshow(_to_numpy_image(image))
    ax.axis("off")
    if show:
        plt.show()
    return fig


def plot_2D_bbox(image, bbox, show: bool = False):
    """Image with its [xmin, xmax, ymin, ymax] box (visualize.py:46-66)."""
    plt = _pyplot()
    from matplotlib.patches import Rectangle

    fig, ax = plt.subplots()
    ax.imshow(_to_numpy_image(image))
    xmin, xmax, ymin, ymax = [float(v) for v in _numpy(bbox)]
    ax.add_patch(Rectangle((xmin, ymin), xmax - xmin, ymax - ymin,
                           fill=False, edgecolor="lime", linewidth=2))
    ax.axis("off")
    if show:
        plt.show()
    return fig


def scatter_keypoints(image, x, y, normalized: bool = True, show: bool = False):
    """Image with its keypoints (visualize.py:69-95); ``normalized`` means x
    and y are in [0, 1] and are scaled by the image size."""
    plt = _pyplot()
    img = _to_numpy_image(image)
    h, w = img.shape[:2]
    xs = _numpy(x).astype(np.float64).reshape(-1)
    ys = _numpy(y).astype(np.float64).reshape(-1)
    if normalized:
        xs = xs * w
        ys = ys * h
    fig, ax = plt.subplots()
    ax.imshow(img)
    ax.scatter(xs, ys, c="red", s=24, marker="x")
    ax.axis("off")
    if show:
        plt.show()
    return fig
