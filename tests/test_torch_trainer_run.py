"""The port's trainer end to end on the CPU: the tiny model (``pretrains =
pretraint = "none"``, 32^2, B = 2), two epochs over in-memory photos named
``sNNN.png``, FID stubbed (its parts have their own tests in
tests/test_torch_eval.py), under the cadence of the first trainer call of
``chip_smoke.py``: epoch 0 writes the artifacts, evaluates, saves the
checkpoints and updates the template by EM with a BatchNorm refresh after
it; epoch 1 takes one SWA update.  Checks the run's artifacts, the layout of
tests/test_trainer_integration.py, and that the template moved.  And a
checkpoint round trip: save, restore into a trainer built from another
seed, and the next step is the uninterrupted run's, exactly.

Slow, and two test functions on purpose: under ``pytest -n 6 --dist
loadfile`` the files with the most tests are handed out first, so a slow
file with few tests runs beside the suite's long files and not ahead of
them.
"""
import dataclasses
import os

import numpy as np
import torch

import magicmirror_torch.train.trainer as trainer_mod
from magicmirror_torch import kernels
from magicmirror_torch.eval.images import read_image
from magicmirror_torch.render.synthetic import smooth_random
from magicmirror_torch.train import METRIC_KEYS, TrainOptions, build_trainer, sample_draws
from magicmirror_torch.train.checkpoints import CheckpointManager
from magicmirror_torch.train.state import swa_update
from torch_parity import SPHERE, drop_checkpoints, t

torch.set_num_threads(1)
S, B = 32, 2


class Loader:
    """Batches of ``{"images", "path"}``, as the trainer reads a loader."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def photo_batches(n_batches, first, seed):
    """Smooth random RGB with an elliptical mask, (B, S, S, 4) float32,
    named sNNN.png from ``first`` on."""
    yy, xx = np.mgrid[0:S, 0:S] / (S - 1) * 2 - 1
    mask = (xx ** 2 / 0.5 + yy ** 2 / 0.8 < 1).astype(np.float32)
    batches = []
    for i in range(n_batches):
        rgb = smooth_random((B, S, S, 3), seed + i)
        images = np.concatenate([rgb, np.broadcast_to(mask[None, ..., None], (B, S, S, 1))], -1)
        names = [f"s{first + B * i + b:03d}.png" for b in range(B)]
        batches.append({"images": images.astype(np.float32), "path": names})
    return batches


def test_trainer_two_epochs_writes_the_reference_artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "fids_against",
                        lambda ref, dirs, batch_size, **kw: [123.0] * len(dirs))
    monkeypatch.setattr(trainer_mod, "load_fid_weights", lambda **kw: None)
    opt = TrainOptions(template_path=SPHERE, imageSize=S, batchSize=B, pretrains="none",
                       pretraint="none", niter=1, warm_epoch=1, swa_start=1, swa_interval=1,
                       em=1.0, em_gap=1, update_bn=True)
    train = photo_batches(2, 0, 0)
    outf = str(tmp_path / "run")
    launches = dict(kernels.LAUNCHES)
    timings = []
    state = trainer_mod.trainer(opt, Loader(train), Loader(photo_batches(1, 100, 5)),
                                Loader(train), outf, device="cpu", timings=timings)
    assert kernels.LAUNCHES == launches  # CPU tensors never reach a kernel

    for name in ("current_Xer.png", "current_Xir.png", "current_randperm_Xa.png",
                 "epoch_000_Iter_0000_Xa.png", "current_mesh_recon.png",
                 "current_mesh_recon.obj", "epoch_000_template.obj", "current_rotation.gif",
                 "current_rotation_ele.gif", "current_rotation_dist.gif",
                 "epoch_000_rotation.gif", "result.txt", "logs/scalars.csv", "trainer.py",
                 "train_step.py", "renderer.py", "ckpts/latest_ckpt", "ckpts/best_ckpt",
                 "ckpts/best_mesh.obj"):
        assert os.path.isfile(os.path.join(outf, name)), name
    assert not os.path.exists(os.path.join(outf, "epoch_001_template.obj"))  # every 10 epochs
    for d in ("ori", "rec", "inter", "inter90", "ori_mask", "rec_mask"):
        names = sorted(os.listdir(os.path.join(outf, "fid", d)))
        expect = ["s100.png", "s101.png"]
        assert names == (sorted(expect + ["2+" + e for e in expect])
                         if d in ("inter", "inter90") else expect), (d, names)
    assert read_image(os.path.join(outf, "fid", "rec", "s100.png")).shape == (S, S, 3)
    assert read_image(os.path.join(outf, "fid", "rec_mask", "s100.png")).shape == (S, S)

    lines = open(os.path.join(outf, "result.txt")).read().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "Epoch 000 recon ssim", "Epoch 000 recon MaskIoU", "Epoch 000 Test recon fid",
        "Epoch 000 Test rotation fid", "Epoch 000 Test rotate90/270 fid"]
    assert lines[2].endswith("123.00")
    ssim, iou = (float(ln.split(": ")[1]) for ln in lines[:2])
    assert -1.0 <= ssim <= 1.0 and 0.0 <= iou <= 1.0

    # EM at epoch 0 moved the template and decayed its step; epoch 1 took one
    # SWA update; the two epochs took two steps each
    template = trainer_mod.build_trainer(opt, "cpu").state.template
    assert float((state.template - template).abs().max()) > 0.0
    assert state.em_step == float(np.float32(np.float32(0.1) * 0.99))
    assert state.swa_n == 1 and state.step == 4 and state.epoch == 1
    assert [t["epoch"] for t in timings] == [0, 1]
    assert [c["name"] for c in timings[0]["checkpoints"]] == ["latest_ckpt", "best_ckpt"]
    assert "em_update_bn_s" in timings[0] and "em_s" not in timings[1]
    drop_checkpoints(tmp_path)


def test_checkpoint_round_trip_resumes_the_run(tmp_path):
    """Save after one step, restore into a trainer built from another seed:
    the next step is the uninterrupted run's, bit for bit."""
    rs = np.random.RandomState(1)
    photos = [t(rs.rand(B, S, S, 4).astype(np.float32)) for _ in range(2)]
    opt = TrainOptions(template_path=SPHERE, imageSize=S, batchSize=B, pretrains="none",
                       pretraint="none")
    draws = [sample_draws(opt, B, torch.Generator().manual_seed(s), "cpu") for s in (5, 6)]
    run = build_trainer(opt, device="cpu")
    run.step(photos[0], 1e-4, 1e-4, warm_up=0.5, draws=draws[0])
    swa_update(run.state)
    run.state.template = run.state.template + 0.01
    run.state.em_step, run.state.epoch = 0.099, 3
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    assert mgr.restore("latest_ckpt", run.state) is None
    mgr.save("latest_ckpt", run.state, epoch=3)

    resumed = build_trainer(dataclasses.replace(opt, manualSeed=9), device="cpu")
    payload = mgr.restore("latest_ckpt", resumed.state)
    assert payload["epoch"] == 3 and payload["state"] is resumed.state
    a, b = run.state, resumed.state
    assert (b.step, b.swa_n, b.em_step, b.epoch) == (1, 1, 0.099, 3)
    assert torch.equal(a.template, b.template)
    for x in (run, resumed):
        x.state.netE.set_dropout_generator(torch.Generator().manual_seed(7))
    ma = run.step(photos[1], 1e-4, 1e-4, draws=draws[1])[0]
    mb = resumed.step(photos[1], 1e-4, 1e-4, draws=draws[1])[0]
    assert all(float(ma[k]) == float(mb[k]) for k in METRIC_KEYS)
    for net in ("netE", "netD", "swa_netE"):
        sa, sb = (getattr(s, net).state_dict() for s in (a, b))
        assert all(torch.equal(sa[k], sb[k]) for k in sa), net
    for opt_name in ("opt_e", "opt_d"):
        sa, sb = (getattr(s, opt_name).state_dict()["state"] for s in (a, b))
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    drop_checkpoints(tmp_path)
