"""Asset locations (counterpart of ``speedplusbaseline_tpu/io_utils/
assets.py``): the repo's ``assets/`` directory, overridable through
``SPEEDPLUS_ASSETS_DIR``. The style-embedding and Ghiasi loaders this slice
needs live in ``augment/styleaug.py``."""
from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_assets_dir() -> str:
    return os.environ.get("SPEEDPLUS_ASSETS_DIR") or os.path.join(_REPO_ROOT, "assets")
