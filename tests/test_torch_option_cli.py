"""A run trained under the off-default options through the Market CLI, and
served by the eval CLI: ``python -m magicmirror_torch.cli.train_market``
at the Market recipe's flags with the tiny model of
tests/test_torch_recipe_cli.py (64 x 32, batch 2, one epoch, FID stubbed)
plus ``--norm ibn --makeup 2 --nolpl --inv 0.5 --lambda_lc 0.1 --gan_type
lsgan --dis2 0.1 --hmr 1`` over a Market tree with a body mesh beside every
mask (``bodymesh/``), then ``python -m magicmirror_torch.cli.test`` on the
run, which reads the encoder options back from its opts.yaml.

Checked: the steps train (finite losses, the option's terms in them), the
critic, optimizer and landmark head the options pick, opts.yaml written as
the CLI's parser makes it and read back into the same TrainOptions, the
checkpoints, and the eval CLI's files and metrics from an encoder built
with the run's options and loaded strictly from its checkpoint.
"""
import os
import re

import numpy as np
import torch
import yaml

import magicmirror_torch.train.trainer as trainer_mod
from magicmirror_torch.cli import test as ptest
from magicmirror_torch.cli import train_market
from magicmirror_torch.configs import flags
from magicmirror_torch.configs.recipes import MARKET_DEFAULTS
from magicmirror_torch.models.discriminators import MSDiscriminator
from magicmirror_torch.train import train_options
from test_torch_recipe_cli import tiny_argv
from test_torch_recipe_data import body_meshes, market_tree
from torch_parity import drop_checkpoints

torch.set_num_threads(1)
OPTION_FLAGS = ["--norm", "ibn", "--makeup", "2", "--nolpl", "--inv", "0.5", "--lambda_lc",
                "0.1", "--gan_type", "lsgan", "--dis2", "0.1", "--hmr", "1"]


def test_market_cli_trains_under_the_options_and_the_eval_cli_serves_it(
        tmp_path, monkeypatch, capsys):
    root = market_tree(tmp_path / "Market")
    body_meshes(root)
    argv = tiny_argv("recipe_market", root, *OPTION_FLAGS, "--name", "MKT_options")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trainer_mod, "fids_against",
                        lambda ref, dirs, batch_size, **kw: [123.0] * len(dirs))
    monkeypatch.setattr(trainer_mod, "load_fid_weights", lambda **kw: None)
    state = train_market.main(argv, device="cpu")
    out = capsys.readouterr().out
    losses = [[float(x) for x in re.findall(r"(?:lossD|lossR): (\S+)", ln)]
              for ln in out.splitlines() if "lossD:" in ln]
    assert losses and all(np.isfinite(v).all() for v in losses)
    assert (state.step, state.epoch) == (2, 0)
    assert isinstance(state.netD, MSDiscriminator) and state.precond_M is not None
    assert hasattr(state.netE, "landmark_cls") and state.netE.texture_enc.refine

    outf = os.path.join("log", "MKT_options")
    with open(os.path.join(outf, "opts.yaml")) as fp:
        saved = yaml.safe_load(fp)
    expect = flags.finalize_options(flags.build_parser(MARKET_DEFAULTS).parse_args(argv))
    assert saved == {**vars(expect), "process_index": 0, "process_count": 1}
    read_back = flags.load_options(flags.build_parser(MARKET_DEFAULTS).parse_args(
        ["--name", "MKT_options"]), os.path.join(outf, "opts.yaml"), skip=("name",))
    assert train_options(read_back) == train_options(expect)
    for name in ("ckpts/latest_ckpt", "ckpts/best_ckpt", "ckpts/best_mesh.obj", "result.txt"):
        assert os.path.isfile(os.path.join(outf, name)), name

    monkeypatch.setattr(ptest, "fids_against", lambda ref, dirs, *a, **k: [7.0] * len(dirs))
    result = ptest.main(["--name", "MKT_options", "--dataroot", root], device="cpu")
    assert result["images"] == 3 and result["fid"] == [7.0] * 3
    assert np.isfinite([result["ssim"], result["mask_iou"]]).all()
    assert len(os.listdir(os.path.join(outf, "fid", "rec"))) == 3
    opt = ptest.eval_options(["--name", "MKT_options"])
    rec = ptest.load_reconstructor(opt, "cpu")
    modules = {type(m).__name__ for m in rec.netE.modules()}
    assert {"IBN", "FeatureEncoder", "LandmarkConsistency"} <= modules
    assert rec.netE.shape_enc.nolpl and rec.netE.camera_enc.nolpl
    drop_checkpoints(tmp_path)
