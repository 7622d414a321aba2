"""Evaluation metrics, the port of ``magicmirror/eval/metrics.py``: windowed
SSIM, mask IoU and the normal-map MSE.

SSIM has ``pytorch_msssim.ssim``'s defaults: an 11 x 11 Gaussian window of
sigma 1.5, K = (0.01, 0.03), data range 1, valid-window filtering, averaged
over channels and batch.  Images are NHWC.  The window filter is a float32
convolution without TF32, as the JAX package runs it at ``Precision.HIGHEST``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..losses.recon import mask_iou_loss
from ..serve import _no_tf32


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


@_no_tf32()
def ssim(img1, img2, data_range: float = 1.0, window_size: int = 11, sigma: float = 1.5,
         K=(0.01, 0.03)):
    """SSIM of two NHWC image batches -> the scalar mean (0-dim tensor)."""
    C = img1.shape[-1]
    win = torch.as_tensor(_gaussian_window(window_size, sigma), device=img1.device)
    kernel = win.expand(C, 1, window_size, window_size).contiguous()

    def filt(x):  # per channel, valid window
        return F.conv2d(x.permute(0, 3, 1, 2), kernel, groups=C)

    C1 = (K[0] * data_range) ** 2
    C2 = (K[1] * data_range) ** 2
    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # clamp tiny negative residual variances (the float32 cancellation floor)
    sigma1_sq = (filt(img1 * img1) - mu1_sq).clamp(min=0.0)
    sigma2_sq = (filt(img2 * img2) - mu2_sq).clamp(min=0.0)
    sigma12 = filt(img1 * img2) - mu12
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def mask_iou_metric(pred_mask, gt_mask):
    """IoU in [0, 1] of (B, H, W) masks: 1 - the soft mask-IoU loss."""
    return 1.0 - mask_iou_loss(pred_mask, gt_mask)


def normal_mse(pred_normals, gt_normals, mask=None):
    """Rendered against ground-truth normal maps (B, H, W, 3): the MSE, over
    the pixels of ``mask`` (B, H, W) when given."""
    err = (pred_normals - gt_normals) ** 2
    if mask is not None:
        err = err * mask[..., None]
        return err.sum() / (mask.sum() * pred_normals.shape[-1] + 1e-8)
    return err.mean()
