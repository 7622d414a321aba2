"""FID between two directories of images, the port of
``magicmirror/eval/fid.py``: InceptionV3 pool3 activations of every image
(on the card unless the caller asks for another device) -> mean and
covariance -> the Frechet distance, with scipy's ``sqrtm`` on the host and
pytorch-fid's rule for a singular product (retry with eps on the
diagonal).  ``fids_against`` takes several FIDs against one reference
directory: its statistics once, the distances at once in processes of
their own (this module run as ``__main__`` computes one).
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import torch

from .. import resolve_device
from ..serve import _no_tf32
from .images import read_image
from .inception import load_fid_weights

IMAGE_EXTENSIONS = ("jpg", "jpeg", "png")


def _list_images(path):
    files = []
    for root, _, names in os.walk(path):
        for name in sorted(names):
            if name.split(".")[-1].lower() in IMAGE_EXTENSIONS:
                files.append(os.path.join(root, name))
    return sorted(files)


@_no_tf32()
@torch.no_grad()
def get_activations(files, model, batch_size: int = 64) -> np.ndarray:
    """(N, 2048) pool3 activations of the image ``files`` through ``model``
    (an :class:`InceptionV3FID`, on the device it lies on), float32 without
    TF32."""
    device = next(model.parameters()).device
    acts = []
    for i in range(0, len(files), batch_size):
        imgs = np.stack([read_image(f, "RGB") for f in files[i:i + batch_size]])
        x = torch.as_tensor(imgs, device=device).permute(0, 3, 1, 2).float() / 255.0
        acts.append(model(x).cpu().numpy())
    return np.concatenate(acts, axis=0)


def calculate_activation_statistics(files, model, batch_size: int = 64):
    act = get_activations(files, model, batch_size)
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6):
    """Frechet distance between two Gaussians, pytorch-fid's numerics."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    with warnings.catch_warnings():
        # with fewer samples than dimensions the covariances are singular and
        # scipy says so; the eps retry below is the rule for that.  ``disp``
        # is deprecated in newer scipy and gone in the newest
        warnings.filterwarnings("ignore", message=".*singular.*")
        warnings.filterwarnings("ignore", category=DeprecationWarning)
        try:
            covmean, _ = linalg.sqrtm(sigma1.dot(sigma2), disp=False)
        except TypeError:
            covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    tr_covmean = np.trace(covmean)
    return diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean


def calculate_fid_given_paths(paths, batch_size: int = 64, model=None, weights_path=None,
                              device="cuda") -> float:
    """FID between the images of two directories.  ``model``: an
    :class:`InceptionV3FID` to use; else one is loaded from ``weights_path``
    onto ``device`` (the card unless another device is named)."""
    for p in paths:
        if not os.path.exists(p):
            raise RuntimeError(f"Invalid path: {p}")
    if model is None:
        model = load_fid_weights(weights_path, resolve_device(device))
    stats = [calculate_activation_statistics(_list_images(p), model, batch_size)
             for p in paths]
    return float(calculate_frechet_distance(stats[0][0], stats[0][1], stats[1][0],
                                            stats[1][1]))


# the variables that size the BLAS thread pools, read when numpy loads
_BLAS_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
                 "BLIS_NUM_THREADS")
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def frechet_distances(ref_stats, stats) -> list[float]:
    """The Frechet distance of each (mu, sigma) of ``stats`` to
    ``ref_stats``.  One is computed here; several at once, each in a Python
    process of its own (``python -m magicmirror_torch.eval.fid REF JOB``,
    the statistics passed in npz files) with an equal share of the CPUs as
    its BLAS threads: a distance is a ``sqrtm`` of a 2,048^2 product, seconds
    of the host, and in threads of one process several run no faster than
    one after another.  (On an H100's host of 8 CPUs, three at once took
    25-28 s where three in a row took 32-40 s.)"""
    if len(stats) <= 1:
        return [float(calculate_frechet_distance(*ref_stats, *s)) for s in stats]
    threads = str(max(1, (os.cpu_count() or 1) // len(stats)))
    env = {**os.environ, **dict.fromkeys(_BLAS_THREADS, threads),
           "PYTHONPATH": os.pathsep.join(filter(None, [_PACKAGE_ROOT,
                                                       os.environ.get("PYTHONPATH")]))}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.npz")
        np.savez(ref, mu=ref_stats[0], sigma=ref_stats[1])
        jobs = [os.path.join(tmp, f"{i}.npz") for i in range(len(stats))]
        for job, (mu, sigma) in zip(jobs, stats):
            np.savez(job, mu=mu, sigma=sigma)
        procs = [subprocess.Popen([sys.executable, "-m", __name__, ref, job], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for job in jobs]
        results = [proc.communicate() for proc in procs]  # every process waited for
    out = []
    for proc, (stdout, stderr) in zip(procs, results):
        if proc.returncode:
            raise RuntimeError(f"the Frechet distance process failed: {stderr[-2000:]}")
        out.append(float(stdout.split()[-1]))
    return out


def fids_against(ref_dir, dirs, batch_size: int = 64, model=None, weights_path=None,
                 device="cuda") -> list[float]:
    """The FID of each of ``dirs`` against ``ref_dir``, each the number
    ``calculate_fid_given_paths([ref_dir, d])`` gives, with the reference's
    statistics taken once and the distances computed at once
    (:func:`frechet_distances`)."""
    for p in (ref_dir, *dirs):
        if not os.path.exists(p):
            raise RuntimeError(f"Invalid path: {p}")
    if model is None:
        model = load_fid_weights(weights_path, resolve_device(device))
    ref = calculate_activation_statistics(_list_images(ref_dir), model, batch_size)
    stats = [calculate_activation_statistics(_list_images(d), model, batch_size)
             for d in dirs]
    return frechet_distances(ref, stats)


if __name__ == "__main__":
    # one distance of frechet_distances: REF and JOB are npz files of mu, sigma
    stats = [np.load(path) for path in sys.argv[1:3]]
    print(repr(float(calculate_frechet_distance(stats[0]["mu"], stats[0]["sigma"],
                                                stats[1]["mu"], stats[1]["sigma"]))))
