"""ATR human training at 1:1 aspect (reference train_ATR.py), the port of
``magicmirror/cli/train_atr.py``: the ATR dataset (``data/atr.py``), the
flags' defaults ``ATR_DEFAULTS``.

    python -m magicmirror_torch.cli.train_atr --name X --dataroot ../ATR/humanparsing/Seg [flags]

``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

from ..configs.flags import build_parser
from ..configs.recipes import ATR_DEFAULTS
from ..data.atr import ATRDataset
from .train import build_dataloaders, train_from_flags


def main(argv=None, device="cuda", timings=None):
    """As ``cli.train.main``, over the ATR dataset."""
    return train_from_flags(build_parser(ATR_DEFAULTS).parse_args(argv),
                            lambda opt: build_dataloaders(opt, dataset_cls=ATRDataset),
                            device, timings)


if __name__ == "__main__":
    main()
