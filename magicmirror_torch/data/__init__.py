"""The datasets and the loader of ``python train.py``, the port of
``magicmirror/data`` (CUB; the other datasets are not ported yet).  numpy
only: Pillow is imported only to decode a JPEG."""
from .cub import CUBDataset
from .loader import DataLoader

__all__ = ["CUBDataset", "DataLoader"]
