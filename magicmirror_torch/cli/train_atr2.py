"""ATR training at a free aspect ratio (reference train_ATR2.py), the port
of ``magicmirror/cli/train_atr2.py``: non-square renders over the ATR2
dataset (``data/atr2.py``), the flags' defaults ``ATR2_DEFAULTS``.

    python -m magicmirror_torch.cli.train_atr2 --name X --dataroot ../ATR/humanparsing/Seg [flags]

Its three loaders are its own: the clean ("noaug") loader augments too
(``aug=True``, as the reference's train_ATR2.py:158 does), and the test
split is fg-ratio filtered.  ``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

from ..configs.flags import build_parser
from ..configs.recipes import ATR2_DEFAULTS
from ..data.atr2 import ATR2Dataset
from ..data.loader import DataLoader
from .train import train_from_flags


def build_dataloaders(opt):
    """(train, test, noaug) loaders of the ATR2 run."""
    def dataset(train, aug, threshold):
        return ATR2Dataset(opt.dataroot, opt.imageSize, ratio=opt.ratio, train=train,
                           aug=aug, threshold=threshold, bg=opt.bg)

    train_dl = DataLoader(dataset(True, True, opt.threshold), opt.batchSize,
                          shuffle=True, drop_last=True, num_workers=opt.workers)
    noaug_dl = DataLoader(dataset(True, True, opt.clean_threshold), opt.batchSize,
                          shuffle=True, drop_last=True, num_workers=opt.workers)
    test_dl = DataLoader(dataset(False, False, opt.threshold), opt.batchSize,
                         shuffle=False, num_workers=opt.workers)
    return train_dl, test_dl, noaug_dl


def main(argv=None, device="cuda", timings=None):
    """As ``cli.train.main``, over the ATR2 dataset."""
    return train_from_flags(build_parser(ATR2_DEFAULTS).parse_args(argv), build_dataloaders,
                            device, timings)


if __name__ == "__main__":
    main()
