from .csv_dataset import KRNDataset
from .loader import DataLoader, make_dataloader
from .transforms import random_crop

__all__ = ["KRNDataset", "DataLoader", "make_dataloader", "random_crop"]
