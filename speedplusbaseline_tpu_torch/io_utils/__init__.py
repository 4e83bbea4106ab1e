from .assets import (default_assets_dir, load_attitude_classes, load_camera_intrinsics,
                     load_tango_3d_keypoints)
from .checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from .meters import AverageMeter, report_progress, setup_logger
from .summary import SummaryWriter

__all__ = ["default_assets_dir", "load_attitude_classes", "load_camera_intrinsics",
           "load_tango_3d_keypoints", "checkpoint_exists", "load_checkpoint",
           "save_checkpoint", "AverageMeter", "report_progress", "setup_logger",
           "SummaryWriter"]
