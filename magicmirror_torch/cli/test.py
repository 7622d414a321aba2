"""Metric evaluation entry point (reference test.py), the port of
``magicmirror/cli/test.py``, on the card.

    python -m magicmirror_torch.cli.test --name <model> [--dataroot DIR]

The run's flags are force-overridden from ``./log/<name>/opts.yaml`` but for
the name, dataroot, batch size, workers and resume; the dataset is picked by
a substring of the run's name ("MKT", "ATR2", "ATR", else CUB); the encoder
is ``ckpts/best_ckpt`` (else ``latest_ckpt``) with its SWA average when it
has one, and the template ``ckpts/best_mesh.obj`` where that file is.  The
test set goes through ``serve.Reconstructor`` (the eval step: five renders a
batch), its images are written into ``fid/{ori,rec_tmp,inter,inter90,
ori_mask,rec_mask}``, the predicted attributes into ``hist.png(.npz)``, and
SSIM, mask-IoU (over the written files, CUB at twice ``imageSize``) and
three FIDs into ``result.txt``.  As the JAX CLI, it writes the photos' RGB
as they are (the trainer's eval composites them on white under ``--bg``).

The random views' azimuths come from a ``torch.Generator`` seeded with 0 (the
JAX CLI splits ``PRNGKey(0)`` per batch), or from ``draws``.  The helpers
here (``eval_options``, ``pick_dataset``, ``load_eval_state``,
``load_reconstructor``, ``camera_stats``) serve the other eval CLIs too.
"""
from __future__ import annotations

import json
import os
import time
import types

import numpy as np
import torch

from .. import resolve_device
from ..configs.flags import build_parser, load_options
from ..data import ATR2Dataset, ATRDataset, CUBDataset, DataLoader, MarketDataset
from ..eval.fid import fids_against
from ..eval.images import save_images_parallel
from ..eval.reports import ResultLog, save_histograms
from ..geometry.obj_io import load_obj
from ..render.renderer import DiffRender
from ..serve import Reconstructor, build_models, serve_options
from ..train.trainer import _clock as clock
from ..train.trainer import _images as images
from ..train.trainer import file_metrics

EVAL_DIRS = ("ori", "rec_tmp", "inter", "inter90", "ori_mask", "rec_mask")
# the flags a run's opts.yaml does not override (the JAX load_options' default)
KEEP = ("name", "outf", "dataroot", "batchSize", "workers", "resume")


def eval_options(argv=None, parser=None, keep=KEEP):
    """Parse ``argv``, then take the run's opts.yaml over every flag but
    ``keep`` -> the options, ``outf`` = ./log/<name>."""
    opt = (parser or build_parser()).parse_args(argv)
    opt.outf = "./log/" + opt.name
    opt = load_options(opt, skip=keep)
    opt.outf = "./log/" + opt.name
    return opt


def pick_dataset(opt):
    """The test split of the run's dataset, by a substring of its name."""
    if "MKT" in opt.name:
        return MarketDataset(opt.dataroot, opt.imageSize, train=False, aug=False, bg=opt.bg)
    if "ATR2" in opt.name:
        return ATR2Dataset(opt.dataroot, opt.imageSize, ratio=opt.ratio, train=False,
                           aug=False, bg=opt.bg, threshold=opt.threshold)
    if "ATR" in opt.name:
        return ATRDataset(opt.dataroot, opt.imageSize, train=False, aug=False, bg=opt.bg)
    return CUBDataset(opt.dataroot, opt.imageSize, train=False, aug=False, bg=opt.bg)


def load_eval_state(opt, diff_render: DiffRender, device, use_swa: bool = True):
    """The run's encoder and template -> (netE in eval mode, template (V,
    3)): ``ckpts/best_ckpt``, else ``latest_ckpt``; the SWA average where
    ``use_swa`` and it averages at least one model; the template of
    ``ckpts/best_mesh.obj`` where that file is, else the checkpoint's."""
    ckpts = os.path.join(opt.outf, "ckpts")
    path = next((os.path.join(ckpts, n) for n in ("best_ckpt", "latest_ckpt")
                 if os.path.exists(os.path.join(ckpts, n))), None)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {ckpts}")
    state = torch.load(path, map_location="cpu", weights_only=True)["state"]
    netE = build_models(serve_options(opt), diff_render, device)
    template = state["template"].to(device=device, dtype=torch.float32)
    best_mesh = os.path.join(ckpts, "best_mesh.obj")
    if os.path.isfile(best_mesh):
        template = torch.as_tensor(np.asarray(load_obj(best_mesh).vertices), dtype=torch.float32,
                                   device=device)
        print("loaded template from", best_mesh)
    if use_swa and int(state["swa_n"]) > 0:
        netE.load_state_dict(state["swa_netE"])
        print("using SWA weights (%d averaged)" % int(state["swa_n"]))
    else:
        netE.load_state_dict(state["netE"])
    return netE.eval(), template


def load_reconstructor(opt, device, use_swa: bool = True) -> Reconstructor:
    """The run's renderer (its template, size, ratio, ellipsoid and soft
    mode) and encoder (``load_eval_state``) on ``device``."""
    sopt = serve_options(opt)
    dr = DiffRender(sopt.template_path, sopt.imageSize, ratio=sopt.ratio,
                    init_ellipsoid=sopt.ellipsoid, soft_mode=sopt.soft_mode, device=device)
    netE, template = load_eval_state(opt, dr, device, use_swa)
    return Reconstructor(netE, dr, sopt, template=template)


def camera_stats(Ae) -> dict:
    """The predicted camera of a batch as numpy arrays (B,)."""
    b = Ae["biases"].cpu().numpy()
    return {"azimuths": Ae["azimuths"].cpu().numpy(),
            "elevations": Ae["elevations"].cpu().numpy(),
            "distances": Ae["distances"].cpu().numpy(), "bias_x": b[:, 0], "bias_y": b[:, 1]}


def report_seconds(name, seconds, n_images):
    """Print the CLI's seconds by part as one line."""
    print(f"{name} seconds: " + json.dumps({**seconds, "images": n_images}))


def main(argv=None, device="cuda", draws=None):
    """Evaluate the run ``--name`` on ``device`` (the card unless the caller
    names another) -> {"ssim", "mask_iou", "fid": [recon, rotation,
    rotate90/270], "images", "seconds": {"encode_render" (through the
    loader), "file_writes", "file_metrics", "fid"}}.  ``draws``: an iterable
    of the random views' azimuths (B,), one a batch, in place of the
    generator's."""
    device = resolve_device(device)
    opt = eval_options(argv)
    print(opt)
    loader = DataLoader(pick_dataset(opt), opt.batchSize, shuffle=False,
                        num_workers=opt.workers)
    rec = load_reconstructor(opt, device)
    dirs = tuple(os.path.join(opt.outf, "fid", d) for d in EVAL_DIRS)
    for d in dirs:  # emptied of an earlier run's files
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))
    ori_dir, rec_dir, inter_dir, inter90_dir, ori_mask_dir, rec_mask_dir = dirs

    generator = torch.Generator(device=device).manual_seed(0)
    draws = None if draws is None else iter(draws)
    stats = {k: [] for k in ("azimuths", "elevations", "distances", "bias_x", "bias_y",
                             "delta_norm")}
    to_save, n_images, seconds = [], 0, {}
    t0 = clock(device)
    for data in loader:
        Xa = images(data, device)
        az = None if draws is None else torch.as_tensor(next(draws), dtype=torch.float32,
                                                        device=device)
        *renders, Ae = rec(Xa, random_azimuths=az, generator=generator)
        for k, v in camera_stats(Ae).items():
            stats[k].append(v)
        stats["delta_norm"].append(Ae["delta_vertices"].norm(dim=-1).mean(-1).cpu().numpy())
        Xa, Xer, Xir, Xir2, Xer90, Xer270 = (t.cpu().numpy() for t in (Xa, *renders))
        for b, path in enumerate(data["path"]):
            name = os.path.basename(path)
            to_save += [(Xer[b, :, :, :3], os.path.join(rec_dir, name)),
                        (Xir[b, :, :, :3], os.path.join(inter_dir, name)),
                        (Xir2[b, :, :, :3], os.path.join(inter_dir, "2+" + name)),
                        (Xer90[b, :, :, :3], os.path.join(inter90_dir, name)),
                        (Xer270[b, :, :, :3], os.path.join(inter90_dir, "2+" + name)),
                        (Xer[b, :, :, 3], os.path.join(rec_mask_dir, name)),
                        (Xa[b, :, :, :3], os.path.join(ori_dir, name)),
                        (Xa[b, :, :, 3], os.path.join(ori_mask_dir, name))]
        n_images += len(data["path"])
    seconds["encode_render"] = clock(device) - t0

    t0 = time.perf_counter()
    save_images_parallel(to_save, workers=4)
    save_histograms({k: np.concatenate(v) for k, v in stats.items()},
                    os.path.join(opt.outf, "hist.png"))
    seconds["file_writes"] = time.perf_counter() - t0

    # CUB is measured at twice its size (Market and ATR at theirs)
    scale = 1 if "ATR" in opt.name or "MKT" in opt.name else 2
    t0 = time.perf_counter()
    s, iou = file_metrics(types.SimpleNamespace(imageSize=opt.imageSize * scale,
                                                ratio=opt.ratio), dirs, device)
    seconds["file_metrics"] = time.perf_counter() - t0
    print("Test recon ssim: %0.3f" % s)
    print("Test recon MaskIoU: %0.3f" % iou)
    t0 = time.perf_counter()
    fid_recon, fid_inter, fid_90 = fids_against(ori_dir, [rec_dir, inter_dir, inter90_dir],
                                                64, device=device)
    seconds["fid"] = time.perf_counter() - t0
    print("Test recon fid: %0.2f" % fid_recon)
    print("Test rotation fid: %0.2f" % fid_inter)
    print("Test rotate90/270 fid: %0.2f" % fid_90)
    result = ResultLog(os.path.join(opt.outf, "result.txt"))
    result.write("Final recon ssim: %0.3f" % s)
    result.write("Final recon MaskIoU: %0.3f" % iou)
    result.write("Final Test recon fid: %0.2f" % fid_recon)
    result.write("Final Test rotation fid: %0.2f" % fid_inter)
    result.write("Final Test rotate90/270 fid: %0.2f" % fid_90)
    report_seconds("test", seconds, n_images)
    return {"ssim": s, "mask_iou": iou, "fid": [fid_recon, fid_inter, fid_90],
            "images": n_images, "seconds": seconds}


if __name__ == "__main__":
    main()
