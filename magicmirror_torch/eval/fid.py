"""FID between two directories of images, the port of
``magicmirror/eval/fid.py``: InceptionV3 pool3 activations of every image
(on the card unless the caller asks for another device) -> mean and
covariance -> the Frechet distance, with scipy's ``sqrtm`` on the host and
pytorch-fid's rule for a singular product (retry with eps on the
diagonal)."""
from __future__ import annotations

import os
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
