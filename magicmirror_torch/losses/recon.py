"""Image / mask reconstruction losses, the port of
``magicmirror/losses/recon.py``.  Images are NHWC float in [0, 1]; channel 3
is the mask."""
from __future__ import annotations

import torch.nn.functional as F


def mask_iou_loss(pred_mask, gt_mask, eps: float = 1e-6):
    """Soft mask-IoU loss (1 - IoU) of (B, H, W) masks in [0, 1]."""
    B = pred_mask.shape[0]
    p = pred_mask.reshape(B, -1)
    g = gt_mask.reshape(B, -1)
    inter = (p * g).sum(dim=1)
    union = (p + g - p * g).sum(dim=1)
    return 1.0 - (inter / (union + eps)).mean()


def _resize_nearest(x, h, w):
    """(B, H, W) -> (B, h, w) by nearest resampling with half-pixel centres,
    as ``jax.image.resize(method='nearest')`` samples."""
    return F.interpolate(x[:, None], size=(h, w), mode="nearest-exact")[:, 0]


def contour_loss(pred_mask, gt_mask):
    """Band-pass contour consistency: a mask minus its 4x down-up resampled
    self isolates the contour; the MSE between the two contours."""
    _, H, W = gt_mask.shape

    def contour(m):
        return (m - _resize_nearest(_resize_nearest(m, H // 4, W // 4), H, W)).abs()

    return ((contour(pred_mask) - contour(gt_mask)) ** 2).mean()


def recon_data(pred_data, gt_data, image_weight: float = 0.1, no_mask: bool = False,
               contour: float = 0.0):
    """L1 image + mask-IoU (+ contour) reconstruction loss of (B, H, W, 4)
    RGBA batches; both images are composited on white under the true mask."""
    gt_mask = gt_data[..., 3]
    gt_m = gt_mask[..., None]
    gt_img = gt_data[..., :3] * gt_m + (1.0 - gt_m)
    pred_img = pred_data[..., :3] * gt_m + (1.0 - gt_m)
    loss_image = (pred_img - gt_img).abs().mean()
    loss_mask = mask_iou_loss(pred_data[..., 3], gt_mask)
    if contour > 0:
        loss_mask = loss_mask + contour * contour_loss(pred_data[..., 3], gt_mask)
    return image_weight * loss_image + 1.0 * loss_mask
