"""``python -m magicmirror_torch.cli.test`` against ``magicmirror/cli/test.py``
on the same tree and the same checkpoint (the JAX package's, converted:
``torch_parity.jax_run`` / ``port_run``), on the CPU, FID stubbed on both
sides and the random views' azimuths injected into the port (the JAX CLI
draws them from ``PRNGKey(0)`` split per batch).

Every image both CLIs write, captured at ``save_images_parallel``: the same
paths; the photos and their masks equal (within 1/255 for a JPEG's
decode), the renders to ``magicmirror_torch/parity.py``'s slice
tolerances, the random views too since the draws are the same.  The
histograms' npz to the slice's attribute tolerances; SSIM and mask-IoU
(over the written files, at twice the size for CUB) within 1e-3, and
``result.txt`` line for line.  Then the port alone: under ``--bg`` the
photos are written as they are; without ``best_ckpt`` the run falls back to
``latest_ckpt``; with ``swa_n`` 0 the live encoder serves.

Two test functions: the file compiles a JAX eval step (ROADMAP §1 rules).
"""
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

import magicmirror.cli.test as jtest
import magicmirror_torch.cli.test as ptest
from magicmirror_torch import kernels, parity
from magicmirror_torch.configs import flags
from magicmirror_torch.data import CUBDataset
from magicmirror_torch.render.renderer import DiffRender
from magicmirror_torch.train import build_trainer, train_options
from magicmirror_torch.train.checkpoints import CheckpointManager
from test_torch_data import cub_tree
from torch_parity import TINY_FLAGS, jax_run, port_run, zeros_train_state

torch.set_num_threads(1)
ANGLES = ("azimuths", "elevations")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(tree, the JAX run's root, the port's root): the JAX run saved by the
    JAX package, converted into the port's."""
    tree = cub_tree(tmp_path_factory.mktemp("cub"))
    jroot, proot = (str(tmp_path_factory.mktemp(k)) for k in ("jax", "port"))
    jax_run(jroot, dataroot=tree)
    port_run(jroot, proot)
    yield tree, jroot, proot
    for root in (jroot, proot):  # two runs' checkpoints, over a GB
        shutil.rmtree(root, ignore_errors=True)


def _capture(monkeypatch, module, saved):
    """Record ``module.save_images_parallel``'s pairs, then write them."""
    real = module.save_images_parallel

    def capture(pairs, workers=4):
        saved.extend((np.asarray(a), p) for a, p in pairs)
        real(pairs, workers)

    monkeypatch.setattr(module, "save_images_parallel", capture)


def _jax_draws(n_batches, batch, azi_scope):
    """The random views' azimuths of the JAX CLI, batch by batch."""
    rng, out = jax.random.PRNGKey(0), []
    for _ in range(n_batches):
        rng, sub = jax.random.split(rng)
        out.append(np.array(-jax.random.uniform(sub, (batch,), minval=-azi_scope / 2,
                                                  maxval=azi_scope / 2)))
    return out


def _by_dir(saved, root):
    """{(directory, name): array} of the captured writes, relative to root."""
    out = {}
    for a, p in saved:
        rel = os.path.relpath(os.path.join(root, p) if not os.path.isabs(p) else p, root)
        d, name = os.path.split(rel)
        out[(os.path.basename(d), name)] = a
    return out


def test_the_eval_cli_matches_the_jax_cli(runs, monkeypatch):
    tree, jroot, proot = runs
    argv = ["--name", "clitest", "--dataroot", tree]

    # the JAX CLI: its state restored into zeros of its structure (the init
    # need not be compiled for that), FID stubbed, its writes and metrics kept
    jsaved, jmetrics = [], []
    monkeypatch.setattr(jtest, "create_train_state", zeros_train_state)
    monkeypatch.setattr(jtest, "calculate_fid_given_paths", lambda paths, bs: 42.0)
    real_metrics = jtest.file_metrics
    monkeypatch.setattr(jtest, "file_metrics",
                        lambda o, d: jmetrics.append(real_metrics(o, d)) or jmetrics[-1])
    _capture(monkeypatch, jtest, jsaved)
    monkeypatch.chdir(jroot)
    jtest.main(argv)

    psaved = []
    monkeypatch.setattr(ptest, "fids_against", lambda ref, dirs, *a, **k: [42.0] * len(dirs))
    _capture(monkeypatch, ptest, psaved)
    monkeypatch.chdir(proot)
    launches = dict(kernels.LAUNCHES)
    # the batch size is the command line's (32): the four items are one batch
    out = ptest.main(argv, device="cpu", draws=_jax_draws(1, 4, 360.0))
    assert kernels.LAUNCHES == launches  # CPU tensors never reach a kernel

    jfiles, pfiles = _by_dir(jsaved, jroot), _by_dir(psaved, proot)
    assert sorted(jfiles) == sorted(pfiles)
    # two test photos, each twice in the split (CUB's len), written under one name
    assert len(psaved) == 8 * 4 and out["images"] == 4
    assert {k[0] for k in pfiles} == set(ptest.EVAL_DIRS)
    for (d, name), ref in jfiles.items():
        ours = pfiles[(d, name)]
        assert ours.shape == ref.shape, (d, name)
        if d == "ori_mask":
            assert np.array_equal(ours, ref), name
        elif d == "ori":
            assert np.abs(ours - ref).max() <= 1.0 / 255 + 1e-6, name
        else:  # a render: rgb, or the reconstruction's alpha
            channel = slice(3, 4) if d == "rec_mask" else slice(0, 3)
            a, b = (np.zeros(ref.shape[:2] + (4,), np.float32) for _ in range(2))
            a[..., channel] = ref.reshape(ref.shape[:2] + (-1,))
            b[..., channel] = ours.reshape(ours.shape[:2] + (-1,))
            parity.check_renders(parity.render_stats([a[None]], [b[None]]))

    hist = {r: np.load(os.path.join(r, "log", "clitest", "hist.png.npz")) for r in (jroot, proot)}
    assert set(hist[jroot].files) == set(hist[proot].files)
    for key in hist[jroot].files:
        d = hist[proot][key] - hist[jroot][key]
        if key == "azimuths":
            d = (d + 180.0) % 360.0 - 180.0
        tol = parity.SLICE_TOL["angle_deg" if key in ANGLES else "attr"]
        assert np.abs(d).max() <= tol, (key, np.abs(d).max())
    assert os.path.isfile(os.path.join(proot, "log", "clitest", "hist.png"))

    (js, jiou), = jmetrics
    assert abs(out["ssim"] - js) <= 1e-3 and abs(out["mask_iou"] - jiou) <= 1e-3
    lines = {r: open(os.path.join(r, "log", "clitest", "result.txt")).read().splitlines()
             for r in (jroot, proot)}
    assert [re.sub(r"[\d.]+$", "", ln) for ln in lines[jroot]] == [
        re.sub(r"[\d.]+$", "", ln) for ln in lines[proot]]
    assert lines[jroot][2:] == lines[proot][2:]  # the three FID lines, stubbed
    for j, p in zip(lines[jroot][:2], lines[proot][:2]):
        assert abs(float(j.split()[-1]) - float(p.split()[-1])) <= 1e-3 + 1e-9


def _bg_run(root, tree):
    """A port run of the tiny model with ``--bg`` (its encoder has the
    background head) in ``root``: opts.yaml and a best_ckpt."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        ns = flags.finalize_options(flags.build_parser().parse_args(
            ["--name", "bgrun", "--dataroot", tree, "--bg", *TINY_FLAGS]))
        flags.save_options(ns)
        state = build_trainer(train_options(ns), device="cpu").state
        CheckpointManager(os.path.join(ns.outf, "ckpts")).save("best_ckpt", state, 0)
    finally:
        os.chdir(cwd)


def test_the_photos_the_checkpoint_and_the_encoder_it_serves(runs, tmp_path, monkeypatch):
    tree, _, proot = runs
    # --bg: the photos are written as they are, not composited on white
    _bg_run(str(tmp_path), tree)
    psaved = []
    monkeypatch.setattr(ptest, "fids_against", lambda ref, dirs, *a, **k: [0.0] * len(dirs))
    _capture(monkeypatch, ptest, psaved)
    monkeypatch.chdir(tmp_path)
    ptest.main(["--name", "bgrun", "--dataroot", tree], device="cpu")
    photos = CUBDataset(tree, 32, train=False, aug=False, bg=True)
    ori = {os.path.basename(p): a for a, p in psaved if os.sep + "ori" + os.sep in p}
    for i in range(len(photos)):
        item = photos[i]
        rgb = ori[os.path.basename(item["path"])]
        assert np.array_equal(rgb, item["images"][..., :3])
        m = item["images"][..., 3:]
        assert not np.allclose(rgb, rgb * m + (1 - m))  # the background is not white
    os.remove(os.path.join(tmp_path, "log", "bgrun", "ckpts", "best_ckpt"))

    # the checkpoint a run serves, and its encoder (this test is the file's
    # last: it takes the converted run's files away)
    monkeypatch.chdir(proot)
    opt = ptest.eval_options(["--name", "clitest"])
    dr = DiffRender(opt.template_path, opt.imageSize, device="cpu")
    ckpts = os.path.join(proot, "log", "clitest", "ckpts")
    payload = torch.load(os.path.join(ckpts, "best_ckpt"), weights_only=True)
    key = "shape_enc.conv1.weight"
    swa, live = (payload["state"][k][key] for k in ("swa_netE", "netE"))
    saved_template = payload["state"]["template"]
    assert payload["state"]["swa_n"] == 1 and not torch.equal(swa, live)
    netE, template = ptest.load_eval_state(opt, dr, "cpu")
    assert torch.equal(netE.state_dict()[key], swa)
    # the template is best_mesh.obj's, written at its precision
    assert template.dtype == torch.float32
    assert torch.allclose(template, saved_template, rtol=0, atol=1e-6)
    netE, _ = ptest.load_eval_state(opt, dr, "cpu", use_swa=False)
    assert torch.equal(netE.state_dict()[key], live)
    # no best_ckpt and no best_mesh.obj: latest_ckpt and its template; and a
    # checkpoint that averages no model keeps the live encoder
    os.remove(os.path.join(ckpts, "best_ckpt"))
    os.remove(os.path.join(ckpts, "best_mesh.obj"))
    payload["state"]["swa_n"] = 0
    torch.save(payload, os.path.join(ckpts, "latest_ckpt"))
    del payload
    netE, template = ptest.load_eval_state(opt, dr, "cpu")
    assert torch.equal(netE.state_dict()[key], live)
    assert torch.equal(template, saved_template)
    os.remove(os.path.join(ckpts, "latest_ckpt"))
    with pytest.raises(FileNotFoundError):
        ptest.load_eval_state(opt, dr, "cpu")
