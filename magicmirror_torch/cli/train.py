"""CUB training entry point (reference train.py), the port of
``magicmirror/cli/train.py``: the JAX package's flags, opts.yaml and
loaders, and the port's trainer, on the card.

    python -m magicmirror_torch.cli.train --name cub_baseline --dataroot ./data/CUB_Data [flags]

The photos are JPEGs, decoded by Pillow.  The run's directory is
``./log/<name>``.  One process: the
JAX package's multi-host bring-up is not ported.  ``main(argv,
device="cpu")`` runs on the CPU (the tests do).
"""
from __future__ import annotations

import multiprocessing
import random

import numpy as np
import torch

from ..configs.flags import build_parser, finalize_options, save_options
from ..data.cub import CUBDataset
from ..data.loader import DataLoader
from ..train import train_options
from ..train.trainer import trainer


def build_dataloaders(opt, dataset_cls=CUBDataset, **ds_kwargs):
    """Three loaders: aug-train / test / clean-noaug-train
    (reference train.py:156-169)."""
    train_dataset = dataset_cls(opt.dataroot, opt.imageSize, train=True,
                                aug=True, threshold=opt.threshold, bg=opt.bg,
                                **ds_kwargs)
    train_noaug_dataset = dataset_cls(opt.dataroot, opt.imageSize, train=True,
                                      aug=False, threshold=opt.clean_threshold,
                                      bg=opt.bg, **ds_kwargs)
    test_dataset = dataset_cls(opt.dataroot, opt.imageSize, train=False,
                               aug=False, bg=opt.bg, **ds_kwargs)
    train_dl = DataLoader(train_dataset, opt.batchSize, shuffle=True,
                          drop_last=True, num_workers=opt.workers,
                          prefetch_factor=opt.prefetch_factor,
                          seed=opt.manualSeed)
    train_noaug_dl = DataLoader(train_noaug_dataset, opt.batchSize,
                                shuffle=True, drop_last=True,
                                num_workers=opt.workers,
                                prefetch_factor=opt.prefetch_factor,
                                seed=opt.manualSeed)
    test_dl = DataLoader(test_dataset, opt.batchSize, shuffle=False,
                         num_workers=opt.workers, prefetch_factor=2)
    return train_dl, test_dl, train_noaug_dl


def prepare(opt):
    """The reference's post-parse steps: ``./log/<name>``, ``swa_start``,
    the seeds, the worker rule, one process, and ``opts.yaml``."""
    opt = finalize_options(opt)
    print(opt)
    if opt.manualSeed is None:
        opt.manualSeed = random.randint(1, 10000)
    print("Random Seed:", opt.manualSeed)
    random.seed(opt.manualSeed)
    np.random.seed(opt.manualSeed)
    torch.manual_seed(opt.manualSeed)
    if multiprocessing.cpu_count() >= 32:
        opt.workers = 8
        opt.prefetch_factor = 4
    opt.process_index, opt.process_count = 0, 1
    save_options(opt)
    return opt


def train_from_flags(opt, make_loaders, device="cuda", timings=None):
    """Prepare the run of the parsed flags ``opt`` and train on ``device``
    over the (train, test, noaug) loaders ``make_loaders(opt)`` -> the train
    state.  An unported or unknown flag raises before anything is written."""
    train_options(opt)
    opt = prepare(opt)
    train_dl, test_dl, noaug_dl = make_loaders(opt)
    return trainer(train_options(opt), train_dl, test_dl, noaug_dl, opt.outf, device=device,
                   timings=timings)


def main(argv=None, device="cuda", timings=None):
    """Parse ``argv`` (the command line when None), prepare the run and train
    on ``device`` (the card unless the caller names another) -> the train
    state.  ``timings``: see ``train.trainer.trainer``."""
    return train_from_flags(build_parser().parse_args(argv), build_dataloaders, device,
                            timings)


if __name__ == "__main__":
    main()
