"""The datasets and the loader of the train CLIs, the port of
``magicmirror/data`` (CUB, Market, ATR, ATR2 and THuman2).  numpy only:
Pillow is imported only to decode a JPEG."""
from .atr import ATRDataset
from .atr2 import ATR2Dataset
from .cub import CUBDataset
from .loader import DataLoader
from .market import MarketDataset
from .thuman2 import THuman2Dataset

__all__ = ["ATR2Dataset", "ATRDataset", "CUBDataset", "DataLoader", "MarketDataset",
           "THuman2Dataset"]
