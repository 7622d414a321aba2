"""Market-HQ training entry point (reference train_market.py), the port of
``magicmirror/cli/train_market.py``: ratio-2 renders over the Market tree
(``data/market.py``), the flags' defaults ``MARKET_DEFAULTS``.

    python -m magicmirror_torch.cli.train_market --name X --dataroot ../Market/hq/seg_hmr [flags]

``main(argv, device="cpu")`` runs on the CPU.  With ``--hmr W`` the
reconstruction also takes W times the chamfer distance to each photo's HMR
body mesh, read from the ``bodymesh`` tree beside ``seg_hmr``
(``data/market.py``).
"""
from __future__ import annotations

from ..configs.flags import build_parser
from ..configs.recipes import MARKET_DEFAULTS
from ..data.market import MarketDataset
from .train import build_dataloaders, train_from_flags


def main(argv=None, device="cuda", timings=None):
    """As ``cli.train.main``, over the Market dataset."""
    return train_from_flags(
        build_parser(MARKET_DEFAULTS).parse_args(argv),
        lambda opt: build_dataloaders(opt, dataset_cls=MarketDataset, hmr=opt.hmr),
        device, timings)


if __name__ == "__main__":
    main()
