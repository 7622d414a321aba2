"""The trainer around the step, the port of
``magicmirror/train/trainer.py::trainer``: epochs of D-then-G steps with the
warm-up, the ``train_shape`` policy and the learning-rate schedule; SWA and
its BatchNorm refresh; every 10 epochs the artifacts (grids, meshes, the
texture, three camera-sweep GIFs); every 20 the test eval (with and without
SWA once SWA runs): renders through ``serve.Reconstructor``, the files
written, SSIM and mask-IoU over the written files, three FIDs, ``result.txt``
and the checkpoints; and the EM template update before ``swa_start``.

    trainer(opt, train_dl, test_dl, noaug_dl, outf)           # on the card

The loaders are iterables with ``len()`` of ``{"images": (B, H, W, 4)
float32 RGBA, "path": [names]}``; the trainer moves the images to its
device.  The artifacts go to ``outf`` in the reference's layout::

    outf/  train_step.py, trainer.py, renderer.py (the code of the run),
           result.txt, logs/scalars.csv, epoch_%03d_* and current_* images,
           meshes and GIFs, fid/{ori,rec,inter,inter90,ori_mask,rec_mask}/,
           ckpts/{latest_ckpt,best_ckpt,best_mesh.obj}

The random draws come from the trainer's generator (seeded from
``manualSeed``); the eval's random azimuths from a generator seeded with
1234 + epoch.  The JAX package's multi-host branches are not ported.
"""
from __future__ import annotations

import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..eval.fid import calculate_fid_given_paths
from ..eval.gifs import azimuth_sweep, distance_sweep, elevation_sweep
from ..eval.images import read_image, resize_bicubic, save_image_grid, save_images_parallel
from ..eval.inception import fid_weights_available, load_fid_weights
from ..eval.metrics import mask_iou_metric, ssim
from ..eval.reports import ResultLog, SummaryLogger
from ..geometry.obj_io import save_mesh
from ..serve import Reconstructor, _no_tf32
from . import build_trainer, lr_schedule
from .checkpoints import CheckpointManager
from .em_update import apply_template_update, encode_sweep, select_delta
from .state import swa_update, update_bn

# the code of a run, copied into its directory
SNAPSHOT = ("train/trainer.py", "train/train_step.py", "render/renderer.py")
EVAL_DIRS = ("ori", "rec", "inter", "inter90", "ori_mask", "rec_mask")


def _train_shape_policy(opt, it):
    """Per-iteration encoder freezing."""
    if opt.update_shape == -1:
        return (3, 4, 5)[it % 3]
    if opt.update_shape > 0:
        return 2 if it % opt.update_shape == 0 else 1
    return 0


def _warm_up(warm_up, epoch, opt, warm_iteration):
    """The warm-up factor after one more iteration of ``epoch``: up by
    0.99 / warm_iteration, to at most 1, while epoch < warm_epoch."""
    if epoch < opt.warm_epoch:
        return min(1.0, warm_up + 0.99 / warm_iteration)
    return warm_up


def _images(data, device):
    return torch.as_tensor(data["images"], dtype=torch.float32).to(device)


def _clock(device):
    """Host seconds once the device has finished what was queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run_test_eval(opt, rec, test_dl, dirs, epoch, device):
    """Render the test set through ``rec`` and write the eval images ->
    (seconds rendering, seconds writing).  The photos (``ori``) are written
    at epoch 0, or when their directory is empty."""
    ori_dir, rec_dir, inter_dir, inter90_dir, ori_mask_dir, rec_mask_dir = dirs
    generator = torch.Generator(device=device).manual_seed(1234 + epoch)
    write_ori = epoch == 0 or not os.listdir(ori_dir)
    to_save = []
    t0 = _clock(device)
    for data in test_dl:
        Xa = _images(data, device)
        Xa, Xer, Xir, Xir2, Xer90, Xer270 = (
            t.cpu().numpy() for t in (Xa, *rec(Xa, generator=generator)[:5]))
        for b, path in enumerate(data["path"]):
            name = os.path.basename(path)
            to_save += [(Xer[b, :, :, :3], os.path.join(rec_dir, name)),
                        (Xir[b, :, :, :3], os.path.join(inter_dir, name)),
                        (Xir2[b, :, :, :3], os.path.join(inter_dir, "2+" + name)),
                        (Xer90[b, :, :, :3], os.path.join(inter90_dir, name)),
                        (Xer270[b, :, :, :3], os.path.join(inter90_dir, "2+" + name)),
                        (Xer[b, :, :, 3], os.path.join(rec_mask_dir, name))]
            if write_ori:
                rgb, m = Xa[b, :, :, :3], Xa[b, :, :, 3:4]
                if opt.bg:
                    rgb = rgb * m + (1 - m)
                to_save += [(rgb, os.path.join(ori_dir, name)),
                            (Xa[b, :, :, 3], os.path.join(ori_mask_dir, name))]
    t1 = time.perf_counter()
    save_images_parallel(to_save, workers=4)
    return t1 - t0, time.perf_counter() - t1


def file_metrics(opt, dirs, device="cuda"):
    """SSIM and mask-IoU over the WRITTEN files (the JPEG or PNG round trip is
    part of the metric) -> (mean SSIM, mean IoU).  Each file is resampled to
    the eval size (imageSize wide, round(imageSize * ratio) high) as the JAX
    function does it, with Pillow's bicubic ``resize`` (``resize_bicubic``);
    a file of that size is read as it is."""
    device = resolve_device(device)
    ori_dir, rec_dir, _, _, ori_mask_dir, rec_mask_dir = dirs
    size = (opt.imageSize, round(opt.imageSize * opt.ratio))  # (width, height)

    def load(path, mode):
        arr = resize_bicubic(read_image(path, mode), size)
        return torch.as_tensor(arr, device=device)[None].float() / 255.0

    ssim_scores, iou_scores = [], []
    for name in sorted(os.listdir(ori_dir)):
        if not name.lower().endswith(("png", "jpg")):
            continue
        rec_path = os.path.join(rec_dir, name)
        if not os.path.isfile(rec_path):
            continue
        ssim_scores.append(float(ssim(load(os.path.join(ori_dir, name), "RGB"),
                                      load(rec_path, "RGB"))))
        iou_scores.append(float(mask_iou_metric(load(os.path.join(ori_mask_dir, name), "L"),
                                                load(os.path.join(rec_mask_dir, name), "L"))))
    return (float(np.mean(ssim_scores)) if ssim_scores else 0.0,
            float(np.mean(iou_scores)) if iou_scores else 0.0)


def _print_iter(outf, opt, epoch, it, n_iters, m):
    print("Name:", outf)
    print("[%d/%d][%d/%d] lossD: %.4f lossR: %.4f (fake %.4f reg %.4f data %.4f IC %.4f "
          "dis %.4f)" % (epoch, opt.niter, it, n_iters, m["lossD"], m["lossR"],
                         m["lossR_fake"], m["lossR_reg"], m["lossR_data"], m["lossR_IC"],
                         m["lossR_dis"]))


def save_artifacts(outf, epoch, opt, state, dr, generator, batch, Xer, Xir):
    """The every-10-epoch artifacts of the last train batch: five image
    grids, the reconstructed texture, the reconstructed mesh and the
    template, and the three camera-sweep GIFs."""
    Xa_np, Xer_np, Xir_np = (t.cpu().numpy() for t in (batch, Xer, Xir))
    B = Xa_np.shape[0]
    perm_a, perm_b = (torch.randperm(B, generator=generator, device=batch.device).cpu().numpy()
                      for _ in range(2))
    for tag, img in (("randperm_Xa", Xa_np[perm_a, :, :, :3]),
                     ("randperm_Xb", Xa_np[perm_b, :, :, :3]), ("Xa", Xa_np[:, :, :, :3]),
                     ("Xer", Xer_np[:, :, :, :3]), ("Xir", Xir_np[:, :, :, :3])):
        save_image_grid(img, "%s/epoch_%03d_Iter_%04d_%s.png" % (outf, epoch, 0, tag),
                        normalize=True)
        save_image_grid(img, "%s/current_%s.png" % (outf, tag), normalize=True)

    att = Reconstructor(state.netE, dr, opt, template=state.template).encode(batch)
    tex0 = att["textures"][0].cpu().numpy()
    save_image_grid(tex0[None], "%s/current_mesh_recon.png" % outf)
    save_image_grid(tex0[None], "%s/epoch_%03d_mesh_recon.png" % (outf, epoch))
    faces = dr.faces.cpu().numpy()
    save_mesh("%s/current_mesh_recon.obj" % outf, att["vertices"][0].cpu().numpy(), faces,
              dr.uvs)
    save_mesh("%s/epoch_%03d_template.obj" % (outf, epoch), state.template.cpu().numpy(),
              faces, dr.uvs)

    @_no_tf32()
    @torch.no_grad()
    def render(**a):
        return dr.render(**a)

    print("===========Saving Gif-Azi===========")
    azimuth_sweep(render, att, os.path.join(outf, "epoch_%03d_rotation.gif" % epoch),
                  azi_scope=opt.azi_scope, copy_to=os.path.join(outf, "current_rotation.gif"))
    print("===========Saving Gif-Y===========")
    elevation_sweep(render, att, os.path.join(outf, "epoch_%03d_rotation_ele.gif" % epoch),
                    elev_range=opt.elev_range,
                    copy_to=os.path.join(outf, "current_rotation_ele.gif"))
    print("===========Saving Gif-Dist===========")
    distance_sweep(render, att, os.path.join(outf, "epoch_%03d_rotation_dist.gif" % epoch),
                   dist_range=opt.dist_range,
                   copy_to=os.path.join(outf, "current_rotation_dist.gif"))


def trainer(opt, train_dl, test_dl, noaug_dl, outf, device="cuda", timings=None):
    """Train ``opt``'s configuration for epochs ``start .. opt.niter`` (start
    0, or the epoch of ``ckpts/latest_ckpt`` with ``opt.resume``), on the
    card unless ``device`` names another device -> the train state.
    ``timings``: a list that receives one dict of seconds (and checkpoint
    bytes) per epoch, after one for the restore when it resumes."""
    device = resolve_device(device)
    os.makedirs(outf, exist_ok=True)
    package = Path(__file__).resolve().parents[1]
    for src in SNAPSHOT:
        shutil.copy(package / src, os.path.join(outf, os.path.basename(src)))

    train = build_trainer(opt, device)
    state, dr, generator = train.state, train.diff_render, train.generator
    lpl = dr.vertices_laplacian_matrix
    faces = dr.faces.cpu().numpy()

    ckpt = CheckpointManager(os.path.join(outf, "ckpts"))
    start_epoch = 0
    if opt.resume:
        t0 = _clock(device)
        payload = ckpt.restore("latest_ckpt", state)
        if payload is not None:
            start_epoch = payload["epoch"]
            print(f"=> loaded checkpoint (epoch {start_epoch})")
            if timings is not None:
                timings.append({"restore_s": _clock(device) - t0,
                                "restore_bytes": os.path.getsize(ckpt.path("latest_ckpt")),
                                "restored_epoch": start_epoch})
        else:
            print("=> no checkpoint can be found")

    dirs = tuple(os.path.join(outf, "fid", d) for d in EVAL_DIRS)
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    summary = SummaryLogger(os.path.join(outf, "logs"))
    result = ResultLog(os.path.join(outf, "result.txt"))
    fid_model = None

    best_fid = 9999.0
    warm_up = 0.01
    warm_iteration = len(train_dl) * opt.warm_epoch
    print("Model will warm up in %d iterations" % warm_iteration)

    def train_batches():
        return (_images(data, device) for data in train_dl)

    last_batch = last_Xer = last_Xir = None
    try:
        for epoch in range(start_epoch, opt.niter + 1):
            times = {"epoch": epoch, "eval": [], "checkpoints": []}
            state.epoch = epoch
            lr_e = lr_schedule(opt.scheduler, epoch, opt.niter, opt.lr, opt.gamma)
            lr_d = lr_e
            n_iters = len(train_dl)
            t0 = _clock(device)
            for it, data in enumerate(train_dl):
                warm_up = _warm_up(warm_up, epoch, opt, warm_iteration)
                Xa = _images(data, device)
                metrics, Xer, Xir = train.step(Xa, lr_e, lr_d, warm_up=warm_up,
                                               train_shape=_train_shape_policy(opt, it))
                if it % 10 == 0:
                    _print_iter(outf, opt, epoch, it, n_iters,
                                {k: float(v) for k, v in metrics.items()})
                last_batch, last_Xer, last_Xir = Xa, Xer, Xir
            times["train_s"] = _clock(device) - t0
            times["train_images"] = n_iters * (0 if last_batch is None else last_batch.shape[0])

            if opt.swa and epoch >= opt.swa_start and epoch % opt.swa_interval == 0:
                swa_update(state)
                print("How many models are fused: %d" % state.swa_n)

            if opt.swa and epoch >= opt.swa_start and epoch % 20 == 0 and state.swa_n > 0:
                # re-estimate the averaged model's statistics on the train set
                print("===========Updating SWA BatchNorm===========")
                t0 = _clock(device)
                update_bn(state.swa_netE, train_batches(), state.template, lpl, generator,
                          max_batches=50)
                times["swa_bn_s"] = _clock(device) - t0

            if epoch % 10 == 0 and last_batch is not None:
                t0 = _clock(device)
                save_artifacts(outf, epoch, opt, state, dr, generator, last_batch, last_Xer,
                               last_Xir)
                times["artifacts_s"] = _clock(device) - t0

            if epoch % 20 == 0:
                for use_swa in ([False, True] if (opt.swa and epoch >= opt.swa_start)
                                else [False]):
                    tag = " (SWA)" if use_swa else ""
                    ev = {"swa": use_swa}
                    print("===========Generating Test Images%s===========" % tag)
                    rec = Reconstructor(state.swa_netE if use_swa else state.netE, dr, opt,
                                        template=state.template)
                    ev["render_s"], ev["write_s"] = run_test_eval(opt, rec, test_dl, dirs,
                                                                  epoch, device)
                    print("===========Evaluating SSIM & MaskIoU===========")
                    t0 = time.perf_counter()
                    s, iou = file_metrics(opt, dirs, device)
                    ev["file_metrics_s"] = time.perf_counter() - t0
                    print("Test recon ssim: %0.3f" % s)
                    print("Test recon MaskIoU: %0.3f" % iou)
                    print("===========Evaluating FID Score===========")
                    t0 = time.perf_counter()
                    if fid_model is None:
                        fid_model = load_fid_weights(device=device)
                    ori, rec_d, inter, inter90 = dirs[:4]
                    fid_recon = calculate_fid_given_paths([ori, rec_d], 64, model=fid_model)
                    fid_inter = calculate_fid_given_paths([ori, inter], 64, model=fid_model)
                    fid_90 = calculate_fid_given_paths([ori, inter90], 64, model=fid_model)
                    ev["fid_s"] = time.perf_counter() - t0
                    times["eval"].append(ev)
                    print("Epoch %03d fid recon/rot/rot90: %0.2f %0.2f %0.2f"
                          % (epoch, fid_recon, fid_inter, fid_90))
                    summary.add_scalar("Test/fid_recon", fid_recon, epoch)
                    summary.add_scalar("Test/fid_inter", fid_inter, epoch)
                    summary.add_scalar("Test/fid_90", fid_90, epoch)
                    result.write("Epoch %03d recon ssim: %0.3f%s" % (epoch, s, tag))
                    result.write("Epoch %03d recon MaskIoU: %0.3f%s" % (epoch, iou, tag))
                    result.write("Epoch %03d Test recon fid: %0.2f%s" % (epoch, fid_recon, tag))
                    result.write("Epoch %03d Test rotation fid: %0.2f%s"
                                 % (epoch, fid_inter, tag))
                    result.write("Epoch %03d Test rotate90/270 fid: %0.2f%s"
                                 % (epoch, fid_90, tag))

                    print("===========Saving Best Snapshot===========")
                    saves = ["latest_ckpt"]
                    # the best checkpoint is chosen on fid_inter, but only with
                    # real Inception weights: with the random fallback FID is
                    # noise, and the choice falls to mask-IoU (higher is better)
                    if fid_weights_available():
                        crit, better = fid_inter, fid_inter < best_fid
                    else:
                        print("ERROR: FID weights unavailable - best-checkpoint selection "
                              "keyed on mask-IoU instead of fid_inter (convert weights with "
                              "magicmirror/eval/convert_fid_weights.py)")
                        crit, better = -iou, -iou < best_fid
                    if better:
                        saves.append("best_ckpt")
                        best_fid = crit
                    for name in saves:
                        t0 = _clock(device)
                        ckpt.save(name, state, epoch)
                        times["checkpoints"].append(
                            {"name": name, "s": time.perf_counter() - t0,
                             "bytes": os.path.getsize(ckpt.path(name))})
                    if better:
                        ckpt.save_best_mesh(state.template.cpu().numpy(), faces, dr.uvs)

            if opt.em > 0 and epoch % opt.em_gap == 0 and epoch < opt.swa_start:
                print("===========Updating template===========")
                t0 = _clock(device)
                all_v, all_d = [], []
                for data in noaug_dl:
                    v, d = encode_sweep(state.netE, _images(data, device), state.template, lpl,
                                        bool(opt.white))
                    all_v.append(v.cpu().numpy())
                    all_d.append(d.cpu().numpy())
                swept = bool(all_v)
                if swept:
                    all_v, all_d = np.concatenate(all_v), np.concatenate(all_d)
                    sum_delta, count = select_delta(all_v, all_d, opt, dr.num_vertices)
                    print("The template mesh fuses %d / %d meshes" % (count, len(all_v)))
                    new_template, new_em = apply_template_update(
                        state.template.cpu().numpy(), sum_delta, count, lpl.cpu().numpy(),
                        warm_up, state.em_step, opt)
                    state.template = torch.as_tensor(new_template, device=device)
                    state.em_step = float(np.float32(new_em))
                times["em_s"] = _clock(device) - t0
                if swept and opt.update_bn:
                    # the running statistics were estimated against the old
                    # template: refresh the live encoder's
                    print("===========Updating BatchNorm after EM===========")
                    t0 = _clock(device)
                    update_bn(state.netE, train_batches(), state.template, lpl, generator,
                              max_batches=50)
                    times["em_update_bn_s"] = _clock(device) - t0
            if timings is not None:
                timings.append(times)
    finally:
        summary.close()
    return state
