"""The train CLIs' own flag defaults and the three published training
recipes (``docs/RECIPES.md``: CUB, Market-HQ, ATR), as command lines of
the port's CLIs.

``MARKET_DEFAULTS``, ``ATR_DEFAULTS`` and ``ATR2_DEFAULTS`` are the parser
defaults of ``cli.train_market``, ``cli.train_atr`` and ``cli.train_atr2``
(those of ``magicmirror/cli/train_{market,atr,atr2}.py``).  ``RECIPES``
holds each recipe's command line as published, with the CLI that runs it;
``recipe_flags`` parses it as that CLI does.
"""
from __future__ import annotations

import shlex

from .flags import build_parser

MARKET_DEFAULTS = dict(
    name="baseline-MKT",
    dataroot="../Market/hq/seg_hmr",
    ratio=2.0,
    ellipsoid=2.0,
    em=0.0,
    clean_threshold="0.3,0.64",
    threshold="0.09,0.64",
    bias_range=0.5,
    elev_range="-15~15",
    dist_range="2~6",
)
ATR_DEFAULTS = dict(
    name="ATR_baseline",
    dataroot="../ATR/humanparsing/Seg",
    ellipsoid=2.0,
    elev_range="-15~15",
    dist_range="2~6",
)
ATR2_DEFAULTS = dict(
    name="ATR2_baseline",
    dataroot="../ATR/humanparsing/Seg",
    ratio=2.0,
    imageSize=64,
    ellipsoid=2.0,
    elev_range="-15~15",
    dist_range="2~8",
    threshold="0.09,0.49",
    clean_threshold="0.16,0.36",
)
CLI_DEFAULTS = {"train": None, "train_market": MARKET_DEFAULTS, "train_atr": ATR_DEFAULTS,
                "train_atr2": ATR2_DEFAULTS}

# name -> (the CLI module under magicmirror_torch.cli, its argv as published)
RECIPES = {
    "recipe_cub": ("train", shlex.split(
        "--name CUB_wgan_b48 --drop 0.2,0.2,0 --imageSize 128 --batch 48 --gan_type wgan "
        "--bg --L1 --ganw 0 --hard --lr 7e-5 --em 7 --update_shape -1 --lambda_data 2 "
        "--lambda_depthC 0.1 --lambda_flat 0.01 --unmask 2 --em_gap 2 --beta1 0.95 "
        "--update_bn --gamma 0.1 --scheduler restart1 --lambda_contour 0.1")),
    "recipe_market": ("train_market", shlex.split(
        "--name MKT_wgan_b48 --clean 0.36,0.49 --imageSize 64 --batch 48 --gan_type wgan "
        "--bg --L1 --ganw 0 --hard --lr 5e-5 --em 7 --update_shape -1 --lambda_data 2 "
        "--unmask 2 --lambda_flat 0.02 --lambda_depthR 0.15 --drop 0.2,0.2,0 --em_gap 2 "
        "--beta1 0.95 --pretrainc none")),
    "recipe_atr2": ("train_atr2", shlex.split(
        "--name ATR2_wgan_b48 --imageSize 96 --batch 48 --gan_type wgan --bg --L1 --ganw 0 "
        "--hard --lr 5.5e-5 --em 7 --update_shape -1 --unmask 2 --lambda_data 2 "
        "--lambda_flat 0.01 --lambda_depthR 0.15 --drop 0.2,0.2,0.2 --em_gap 2 "
        "--beta1 0.95 --ratio 1.666666 --clean 0.18,0.26 --pretrainc none")),
}


def recipe_flags(name: str) -> dict:
    """The flags of recipe ``name`` as its CLI parses them -> {flag: value}."""
    cli, argv = RECIPES[name]
    return vars(build_parser(CLI_DEFAULTS[cli]).parse_args(argv))
