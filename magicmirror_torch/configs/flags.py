"""The reference CLI flag surface (reference train.py:39-128) and the
opts.yaml round-trip (dumped at train start train.py:150-151, force-overriding
CLI at eval test.py:139-167): the port of ``magicmirror/configs/flags.py``.

Every flag of the JAX package, with its name, default and type, so that
recipes (and prefix matches like ``--clean`` -> ``--clean_threshold``) carry
over; ``argparse`` provides the prefix matching.  Which flags the port's
train step reads, and which it accepts and ignores, is
``train.train_options``.  ``opts.yaml`` is written and read as the JAX
package does it, with the yaml package, which only ``save_options`` and
``load_options`` import.
"""
from __future__ import annotations

import argparse
import os

def build_parser(defaults: dict | None = None) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    a = p.add_argument
    a("--name", default="baseline", help="folder to output images and model checkpoints")
    a("--configs_yml", default="configs/image.yml")
    a("--dataroot", default="./data/CUB_Data", help="path to dataset root dir")
    a("--ratio", type=float, default=1, help="height/width")
    a("--gan_type", default="wgan", help="wgan or lsgan")
    a("--sn_dis", type=int, default=0, help="use the spectral-norm DCGAN critic (reference network/discriminator.py; unused by reference recipes)")
    a("--template_path", default="./template/sphere.obj", help="template mesh path")
    a("--ellipsoid", type=float, default=1, help="init sphere to ellipsoid")
    a("--category", type=str, default="bird")
    a("--pretrains", type=str, default="hr18sv2", help="shape encoder backbone")
    a("--pretrainc", type=str, default="none", help="camera encoder backbone")
    a("--pretraint", type=str, default="res34", help="texture encoder backbone")
    a("--norm", type=str, default="bn")
    a("--workers", type=int, default=4)
    a("--prefetch_factor", type=int, default=3)
    a("--batchSize", type=int, default=32)
    a("--imageSize", type=int, default=128)
    a("--nk", type=int, default=5)
    a("--nf", type=int, default=32)
    a("--niter", type=int, default=600)
    a("--lr", type=float, default=0.0001)
    a("--scheduler", default="cosine")
    a("--clip", type=float, default=0.05)
    a("--azim", type=float, default=1.0)
    a("--beta1", type=float, default=0.5)
    a("--wd", type=float, default=0)
    a("--inv", type=float, default=0)
    a("--droprate", type=str, default="0.2,0.2,0.2")
    a("--cuda", default=1, type=int, help="kept for CLI parity; ignored on TPU")
    a("--manualSeed", type=int, default=0)
    a("--start_epoch", type=int, default=0)
    a("--warm_epoch", type=int, default=40)
    a("--fp16", action="store_true", default=False,
      help="mixed precision; maps to bf16 on TPU")
    a("--multigpus", action="store_true", default=False,
      help="data-parallel over all local TPU chips (jax.sharding mesh)")
    a("--resume", action="store_true", default=False)
    a("--chamfer", type=bool, default=True)
    a("--amsgrad", type=bool, default=True)
    a("--bg", action="store_true", default=False)
    a("--nolpl", action="store_true", default=False)
    a("--white", action="store_true", default=True)
    a("--smooth", type=float, default=0.5)
    a("--makeup", type=int, default=0)
    a("--beta", type=float, default=0)
    a("--hard", action="store_true", default=False)
    a("--cross", action="store_true", default=False)
    a("--adamw", action="store_true", default=False)
    a("--L1", action="store_true", default=False)
    a("--flipL1", action="store_true", default=False)
    a("--coordconv", action="store_false", default=True)
    a("--unmask", type=int, default=0)
    a("--romp", action="store_true", default=False)
    a("--swa", action="store_true", default=True)
    a("--em", type=float, default=1.0)
    a("--em_gap", type=int, default=1)
    a("--eps", type=float, default=0.2, help="DBSCAN eps for em=4")
    a("--topK", type=float, default=0.01, help="top-K fraction for em=5")
    a("--swa_start", type=int, default=500)
    a("--swa_interval", type=int, default=1)
    a("--update_shape", type=int, default=1)
    a("--update_bn", action="store_true", default=False)
    a("--swa_lr", type=float, default=0.0003)
    a("--lambda_gan", type=float, default=0.0001)
    a("--ganw", type=float, default=1)
    a("--lambda_edge", type=float, default=0.001)
    a("--lambda_depth", type=float, default=0)
    a("--lambda_depthR", type=float, default=0)
    a("--lambda_depthC", type=float, default=0)
    a("--lambda_deform", type=float, default=0.1)
    a("--lambda_flipz", type=float, default=0.1)
    a("--lambda_data", type=float, default=1.0)
    a("--lambda_ic", type=float, default=1)
    a("--lambda_reg", type=float, default=0.1)
    a("--lambda_lpl", type=float, default=0.1)
    a("--lambda_flat", type=float, default=0.001)
    a("--gamma", type=float, default=0.01)
    a("--temp", type=float, default=2)
    a("--dis1", type=float, default=0)
    a("--dis2", type=float, default=0)
    a("--lambda_contour", type=float, default=0)
    a("--lambda_lc", type=float, default=0)
    a("--image_weight", type=float, default=1)
    a("--gan_reg", type=float, default=10.0)
    a("--em_step", type=float, default=0.1)
    a("--hmr", type=float, default=0.0)
    a("--threshold", type=str, default="0.16,0.64")
    a("--clean_threshold", type=str, default="0.25,0.49")
    a("--bias_range", type=float, default=0.3)
    a("--azi_scope", type=float, default=360)
    a("--elev_range", type=str, default="0~30")
    a("--hard_range", type=int, default=0)
    a("--dist_range", type=str, default="2~7")
    # --- TPU-framework extensions (no reference counterpart) -------------
    a("--soft_mode", type=str, default="line", choices=["line", "exact"],
      help="soft-silhouette distance: 'line' (v4 fused Pallas kernel, the "
           "fast default) or 'exact' (kaolin segment distances)")
    a("--band_capacity", type=int, default=0,
      help="static per-cell face capacity of the banded rasterizer; 0 = "
           "auto (4x the uniform share, floor 160, rounded up to 8 — see "
           "rasterize_v4.default_capacity; MAGICMIRROR_BAND_CAPACITY also "
           "overrides).  Overflow is counted per step and logged — raise "
           "this if dropped_faces > 0")
    a("--raster_backend", type=str, default="auto",
      choices=["auto", "pallas", "pallas_v3", "xla"],
      help="rasterizer backend; auto = pallas on TPU, xla elsewhere")
    a("--steps_per_call", type=int, default=16,
      help="train iterations executed per jitted dispatch (lax.scan). "
           ">1 amortizes the per-step host overhead of the remote-execution "
           "path (~56 ms at b16/128²).  Each step's math is unchanged, but "
           "the per-step RNG keys come from one split of the group key, so "
           "a run at N>1 is NOT sample-for-sample reproducible against "
           "N=1 (different random streams, same distribution).  Groups "
           "split automatically at train_shape changes and epoch tails. "
           "Default 16 = the measured b48/128² optimum (TRAINBENCH); "
           "set 1 for sequential-split RNG and the smallest traced graph "
           "(CPU runs/tests)")
    a("--donate_state", action="store_true",
      help="donate the train-state buffers to the jitted step (in-place "
           "update).  Saves one state copy of HBM but measured 15-27%% "
           "SLOWER per step through the remote-execution path "
           "(benchmarks/bench_train_step.py DONATE=1; docs/DESIGN.md "
           "train-step table) — off by default, enable only when HBM-bound")
    if defaults:
        p.set_defaults(**defaults)
    return p


def finalize_options(opt):
    """Post-parse adjustments the reference applies (train.py:130-151)."""
    opt.outf = "./log/" + opt.name
    os.makedirs("./log", exist_ok=True)
    os.makedirs(opt.outf, exist_ok=True)
    opt.swa_start = opt.niter - 100  # SWA covers the last 100 epochs
    return opt


def save_options(opt, path=None):
    path = path or os.path.join("log", opt.name, "opts.yaml")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    import yaml  # here, so that the port's modules import without it

    with open(path, "w") as fp:
        yaml.dump(vars(opt), fp, default_flow_style=False)


def load_options(opt, path=None, skip=("name", "outf", "dataroot", "batchSize",
                                       "workers", "resume")):
    """Re-load opts.yaml and force-override CLI values, the reference's eval
    behavior (test.py:139-167).  ``skip`` keys keep their CLI values."""
    path = path or os.path.join("log", opt.name, "opts.yaml")
    import yaml

    with open(path, "r") as fp:
        saved = yaml.safe_load(fp)
    for key, value in saved.items():
        if key in skip:
            continue
        setattr(opt, key, value)
    return opt
