"""The three published recipes' command lines (``docs/RECIPES.md``) and the
Market recipe's CLI end to end on the CPU.

  * Each command line, read from docs/RECIPES.md itself (argparse prefixes
    ``--clean``, ``--drop`` and ``--batch`` included), is the one
    ``configs.recipes.RECIPES`` holds; parsed by the port's CLI parser it is
    the JAX parser's namespace, and it gives ``TrainOptions`` with nothing
    unported (``--bg`` and ``--hard`` among them).
  * ``python -m magicmirror_torch.cli.train_market`` and ``...train_atr2``
    at their recipe's flags each train one epoch (``--niter 0``; the cosine
    schedule divides by niter, so ``--scheduler exp``) of the tiny model on
    ``sphere_dryrun.obj`` at 64 x 32, batch 2, over a tiny tree of their layout
    (tests/test_torch_recipe_data.py's; the ATR split lists read through
    ``data.atr._LIST_DIR``), FID stubbed: opts.yaml, the artifacts and the
    eval files as the CUB CLI writes them (tests/test_torch_cli_train.py).
    ATR2 runs at ``--ratio 2`` in place of the recipe's 1.666666: the tiny
    texture encoder's pyramid needs both sides of the render divisible by
    32 (the recipe's 160 x 96 runs on the card, chip_smoke.py's ``recipes``
    phase).
"""
import os
import re
import shlex

import pytest
import torch
import yaml

import magicmirror_torch.train.trainer as trainer_mod
from magicmirror.cli.train_atr import ATR_DEFAULTS as JATR_DEFAULTS
from magicmirror.cli.train_atr2 import ATR2_DEFAULTS as JATR2_DEFAULTS
from magicmirror.cli.train_market import MARKET_DEFAULTS as JMARKET_DEFAULTS
from magicmirror.configs import flags as jflags
from magicmirror_torch import kernels
from magicmirror_torch.cli import train_atr2, train_market
from magicmirror_torch.configs import flags
from magicmirror_torch.configs.recipes import CLI_DEFAULTS, RECIPES, recipe_flags
from magicmirror_torch.data import atr
from magicmirror_torch.serve import PRESETS
from magicmirror_torch.train import TrainOptions, preset_options, train_options
from test_torch_recipe_data import atr_tree, market_tree
from torch_parity import REPO, drop_checkpoints

DRYRUN = os.path.join(REPO, "template", "sphere_dryrun.obj")

torch.set_num_threads(1)
# the JAX CLI's defaults by the port's CLI module name; the doc's scripts
JAX_DEFAULTS = {"train": None, "train_market": JMARKET_DEFAULTS, "train_atr": JATR_DEFAULTS,
                "train_atr2": JATR2_DEFAULTS}
SCRIPTS = {"train.py": "recipe_cub", "train_market.py": "recipe_market",
           "train_ATR2.py": "recipe_atr2"}


def doc_command_lines():
    """recipe name -> the argv of its ``python <script> ...`` line in
    docs/RECIPES.md (continuation lines joined)."""
    with open(os.path.join(REPO, "docs", "RECIPES.md")) as fp:
        text = fp.read().replace("\\\n", " ")
    out = {}
    for line in re.findall(r"^python (train\S*\.py .*)$", text, flags=re.M):
        words = shlex.split(line)
        out[SCRIPTS[words[0]]] = words[1:]
    return out


def test_recipe_command_lines_parse_as_in_the_jax_package():
    """Each recipe's command line (and each CLI's defaults) as the JAX
    package's parser reads it; nothing of it is unported."""
    doc = doc_command_lines()
    assert set(doc) == set(RECIPES)
    for name, (cli, argv) in RECIPES.items():
        assert doc[name] == argv, name
        ours = flags.build_parser(CLI_DEFAULTS[cli]).parse_args(argv)
        ref = jflags.build_parser(JAX_DEFAULTS[cli]).parse_args(argv)
        assert vars(ours) == vars(ref) == recipe_flags(name), name
        opt = train_options(ours)  # nothing unported
        assert opt.bg and opt.hard and opt.batchSize == 48 and opt.gan_type == "wgan"
        assert opt.template_path == "./template/sphere.obj" and opt.soft_mode == "line"
        # serve.PRESETS holds the same flags
        assert preset_options(TrainOptions, name) == opt
        assert PRESETS[name] == vars(ours)
    for cli, defaults in CLI_DEFAULTS.items():
        assert vars(flags.build_parser(defaults).parse_args([])) == vars(
            jflags.build_parser(JAX_DEFAULTS[cli]).parse_args([])), cli


def tiny_argv(name, dataroot, *extra):
    """The recipe's command line with the tiny model on the 80-face
    ``sphere_dryrun.obj`` (the CPU's plain rasterizer walks every face for
    every pixel, and a run renders some 70 times), one epoch at batch 2 and
    every photo kept; only flags the recipe leaves free or must be cut are
    replaced."""
    return RECIPES[name][1] + [
        "--name", "v", "--dataroot", dataroot, "--imageSize", "32", "--batch", "2",
        "--niter", "0", "--scheduler", "exp", "--warm_epoch", "1", "--pretrains", "none",
        "--pretraint", "none", "--template_path", DRYRUN, "--threshold", "0.1,0.9",
        "--clean", "0.1,0.9", "--workers", "1", *extra]


def run_cli(main, argv, defaults, tmp_path, monkeypatch):
    """``main(argv, device="cpu")`` in ``tmp_path`` with FID stubbed ->
    (state, the run's directory); opts.yaml as the CLI's parser makes it."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trainer_mod, "fids_against",
                        lambda ref, dirs, batch_size, **kw: [123.0] * len(dirs))
    monkeypatch.setattr(trainer_mod, "load_fid_weights", lambda **kw: None)
    launches = dict(kernels.LAUNCHES)
    state = main(argv, device="cpu")
    assert kernels.LAUNCHES == launches  # CPU tensors never reach a kernel
    outf = os.path.join("log", "v")
    with open(os.path.join(outf, "opts.yaml")) as fp:
        saved = yaml.safe_load(fp)
    expect = flags.finalize_options(flags.build_parser(defaults).parse_args(argv))
    assert saved == {**vars(expect), "process_index": 0, "process_count": 1}
    assert saved["bg"] and saved["hard"]
    for name in ("current_Xer.png", "current_rotation.gif", "epoch_000_template.obj",
                 "result.txt", "ckpts/latest_ckpt", "ckpts/best_ckpt"):
        assert os.path.isfile(os.path.join(outf, name)), name
    assert hasattr(state.netE, "bg_enc")
    return state, outf


def test_market_and_atr2_clis_train_one_epoch_at_the_recipe_flags(tmp_path, monkeypatch):
    _market_cli_trains_one_epoch(tmp_path / "market", monkeypatch)
    _atr2_cli_trains_one_epoch(tmp_path / "atr2", monkeypatch)


def _market_cli_trains_one_epoch(tmp_path, monkeypatch):
    tmp_path.mkdir()
    root = market_tree(tmp_path / "Market")
    argv = tiny_argv("recipe_market", root)
    state, outf = run_cli(train_market.main, argv, CLI_DEFAULTS["train_market"], tmp_path,
                          monkeypatch)
    # 5 photos at batch 2: 2 steps; SWA from epoch 0
    assert (state.step, state.epoch, state.swa_n) == (2, 0, 1)
    # the eval images carry the photos' names: the 3 query photos
    assert sorted(os.listdir(os.path.join(outf, "fid", "rec"))) == ["s0.png", "s1.png",
                                                                     "s2.png"]
    # an option outside the port raises before the run writes anything
    with pytest.raises(NotImplementedError, match="pretrainc"):
        train_market.main(argv + ["--name", "w", "--pretrainc", "res18"], device="cpu")
    assert not os.path.exists(os.path.join("log", "w"))
    drop_checkpoints(tmp_path)


def _atr2_cli_trains_one_epoch(tmp_path, monkeypatch):
    tmp_path.mkdir()
    root, lists = atr_tree(tmp_path / "ATR")
    monkeypatch.setattr(atr, "_LIST_DIR", lists)
    argv = tiny_argv("recipe_atr2", root, "--ratio", "2")
    state, outf = run_cli(train_atr2.main, argv, CLI_DEFAULTS["train_atr2"], tmp_path,
                          monkeypatch)
    # 5 photos at batch 2: 2 steps; SWA from epoch 0
    assert (state.step, state.epoch, state.swa_n) == (2, 0, 1)
    assert sorted(os.listdir(os.path.join(outf, "fid", "rec"))) == [
        "a100.jpg", "a101.jpg", "a102.jpg"]
    drop_checkpoints(tmp_path)
