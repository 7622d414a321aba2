"""``python -m magicmirror_torch.cli.train`` end to end on the CPU: one epoch
(``--niter 0``; the cosine schedule divides by niter, in the JAX package
too, so ``--scheduler exp``) of the tiny model at 32^2 over a tiny
CUB-layout tree (tests/test_torch_data.py's), FID stubbed (its parts have
their own tests).
At ``--niter 0`` the reference's ``swa_start = niter - 100`` puts epoch 0
under SWA: the epoch's steps, one SWA update, the SWA BatchNorm refresh, the
artifacts, the eval with and without SWA, and the checkpoints; opts.yaml is
written first and reads back to the run's options.

One test function, on purpose: under ``pytest -n 6 --dist loadfile`` the
files with the most tests are handed out first, so a slow file with few
tests runs beside the suite's long files and not ahead of them.
"""
import os

import torch
import yaml

import magicmirror_torch.train.trainer as trainer_mod
from magicmirror_torch import kernels
from magicmirror_torch.cli import train as cli
from magicmirror_torch.configs import flags
from test_torch_data import cub_tree
from torch_parity import SPHERE, drop_checkpoints

torch.set_num_threads(1)


def test_cli_trains_one_epoch_from_a_cub_tree(tmp_path, monkeypatch):
    root = cub_tree(tmp_path / "cub")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trainer_mod, "fids_against",
                        lambda ref, dirs, batch_size, **kw: [123.0] * len(dirs))
    monkeypatch.setattr(trainer_mod, "load_fid_weights", lambda **kw: None)
    argv = ["--name", "v", "--dataroot", root, "--imageSize", "32", "--batchSize", "2",
            "--niter", "0", "--scheduler", "exp", "--warm_epoch", "1", "--pretrains", "none",
            "--pretraint", "none", "--template_path", SPHERE, "--threshold", "0.1,0.9",
            "--clean", "0.1,0.9", "--workers", "1"]
    launches = dict(kernels.LAUNCHES)
    state = cli.main(argv, device="cpu")
    assert kernels.LAUNCHES == launches  # CPU tensors never reach a kernel

    outf = os.path.join("log", "v")
    with open(os.path.join(outf, "opts.yaml")) as fp:
        saved = yaml.safe_load(fp)
    expect = flags.finalize_options(flags.build_parser().parse_args(argv))
    assert saved == {**vars(expect), "process_index": 0, "process_count": 1}
    assert vars(flags.load_options(flags.build_parser().parse_args(argv), skip=())) == saved

    # 4 photos, each twice an epoch, at batch 2: 4 steps; SWA from epoch 0
    assert (state.step, state.epoch, state.swa_n) == (4, 0, 1)
    for name in ("current_Xer.png", "current_rotation.gif", "epoch_000_template.obj",
                 "result.txt", "ckpts/latest_ckpt", "ckpts/best_ckpt", "trainer.py"):
        assert os.path.isfile(os.path.join(outf, name)), name
    lines = open(os.path.join(outf, "result.txt")).read().splitlines()
    assert len(lines) == 10 and sum("(SWA)" in ln for ln in lines) == 5
    # the eval images carry the photos' names: s0.jpg, s1.jpg of the test split
    assert sorted(os.listdir(os.path.join(outf, "fid", "rec"))) == ["s0.jpg", "s1.jpg"]
    drop_checkpoints(tmp_path)
