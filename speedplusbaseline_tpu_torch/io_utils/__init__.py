from .assets import default_assets_dir
from .checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from .meters import AverageMeter, report_progress, setup_logger
from .summary import SummaryWriter

__all__ = ["default_assets_dir", "checkpoint_exists", "load_checkpoint",
           "save_checkpoint", "AverageMeter", "report_progress", "setup_logger",
           "SummaryWriter"]
