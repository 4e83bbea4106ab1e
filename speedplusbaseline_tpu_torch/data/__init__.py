from .csv_dataset import KRNDataset, SPNDataset, build_dataset
from .loader import DataLoader, make_dataloader
from .transforms import random_crop, resize_crop

__all__ = ["KRNDataset", "SPNDataset", "build_dataset", "DataLoader", "make_dataloader",
           "random_crop", "resize_crop"]
