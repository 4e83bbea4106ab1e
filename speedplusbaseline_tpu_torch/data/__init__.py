from .csv_dataset import KRNDataset, SPNDataset, build_dataset
from .loader import DataLoader, make_dataloader
from .preprocess import get_quat_bins, json2csv
from .synthetic import generate_attitude_classes, generate_fake_speedplus
from .transforms import random_crop, resize_crop

__all__ = ["KRNDataset", "SPNDataset", "build_dataset", "DataLoader", "make_dataloader",
           "get_quat_bins", "json2csv", "generate_attitude_classes", "generate_fake_speedplus",
           "random_crop", "resize_crop"]
