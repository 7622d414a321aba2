"""Keypoint-transfer PCK, the port of ``magicmirror/eval/pck.py`` (the
reference's PCK/test_kp.py math on the port's model outputs).

Two source -> target keypoint transfers:
  * through the texture flow (test_kp.py:124-157): each source keypoint as
    a Gaussian heatmap (PCK/kp_utils.py:42-70), sampled at every face's
    source flow positions; the face of the largest response answers with
    its mean target flow position (an identity grid sampled at the target
    flow, test_kp.py:131-143);
  * through the camera and the mean shape (test_kp.py:159-192): keypoint
    -> the nearest projected vertex in the source view -> that vertex's
    nearest foreground pixel in the target view.

PCK (test_kp.py:246-258, 313-323): L2 errors in the [-1, 1] keypoint frame
scaled by (1 + 2 padding_frac) / 2, thresholded at alpha in {0.1, 0.15},
each keypoint's accuracy over all pairs, then their mean.

The arrays are numpy; the camera math and ``grid_sample`` run in torch on
the CPU (``geometry.camera``, ``ops.sampling.grid_sample``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import camera as cam
from ..ops.sampling import grid_sample


def draw_labelmap(img, pt, sigma):
    """An unnormalised Gaussian (1 at its centre) written into ``img`` (H,
    W) at pixel ``pt`` = (x, y) over a window of +-3 sigma, which it
    REPLACES; as PCK/kp_utils.py:42-70, its int() window truncation too."""
    img = np.asarray(img, np.float32).copy()
    ul = [int(pt[0] - 3 * sigma), int(pt[1] - 3 * sigma)]
    br = [int(pt[0] + 3 * sigma + 1), int(pt[1] + 3 * sigma + 1)]
    if ul[0] >= img.shape[1] or ul[1] >= img.shape[0] or br[0] < 0 or br[1] < 0:
        return img
    size = 6 * sigma + 1
    x = np.arange(0, size, 1, float)
    y = x[:, np.newaxis]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))
    g_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    img_x = max(0, ul[0]), min(br[0], img.shape[1])
    img_y = max(0, ul[1]), min(br[1], img.shape[0])
    img[img_y[0]:img_y[1], img_x[0]:img_x[1]] = g[g_y[0]:g_y[1], g_x[0]:g_x[1]]
    return img


def _sgrid(H, W):
    """The identity grid (H, W, 2) of (x, y) in [-1, 1] at pixel centres
    (``affine_grid``'s identity, align_corners False; y = -1 at row 0)."""
    xs = (2.0 * np.arange(W) + 1.0) / W - 1.0
    ys = (2.0 * np.arange(H) + 1.0) / H - 1.0
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx, gy], -1).astype(np.float32)


def _flow_faces(flow):
    """A flow as (nf, T, 2): an (H, W, 2) grid becomes H * W one-sample
    faces."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim == 3 and flow.shape[-1] == 2 and flow.shape[0] != flow.shape[1]:
        return flow  # already (nf, T, 2)
    if flow.ndim == 3:
        return flow.reshape(-1, 1, 2)
    return flow.reshape(flow.shape[0], -1, 2)


def _grid_sample(image, grid):
    return grid_sample(torch.as_tensor(np.ascontiguousarray(image)),
                       torch.as_tensor(np.ascontiguousarray(grid))).numpy()


def transfer_via_texture_flow(kps_src, flow_src, flow_tgt, image_size=256, sigma=3):
    """``kps_src`` (K, 2) xy in [-1, 1] (y down, row 0 at the top);
    ``flow_*`` (nf, T, 2) each face's image positions in [-1, 1] (or an (H,
    W, 2) grid) -> (K, 2) target xy."""
    fs = _flow_faces(flow_src)
    ft = _flow_faces(flow_tgt)
    H = W = int(image_size)
    p2face = _grid_sample(_sgrid(H, W)[None], ft[None])[0].mean(axis=1)  # (nf, 2)
    kps = np.asarray(kps_src, np.float32)
    K = kps.shape[0]
    hp = np.zeros((K, H, W), np.float32)
    kp_pix = (kps + 1.0) / 2.0 * image_size
    for k in range(K):
        hp[k] = draw_labelmap(hp[k], (kp_pix[k, 0], kp_pix[k, 1]), sigma)
    resp = _grid_sample(hp[..., None], np.broadcast_to(fs[None], (K,) + fs.shape))
    k2face = resp[..., 0].mean(axis=2)  # (K, nf)
    return p2face[k2face.argmax(axis=1)]


def project_vertices(vertices, azimuths, elevations, distances, biases, cam_proj):
    """(V, 3) vertices under one predicted camera -> ((V, 2) NDC xy, (V,)
    camera z); NDC is the model's frame, +y up, row 0 at the top."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    B = np.asarray(azimuths).reshape(-1).shape[0]
    object_pos = torch.cat([t(biases).reshape(B, 2), torch.zeros(B, 1)], dim=1)
    up = torch.tensor([0.0, 1.0, 0.0]).expand(B, 3)
    pos = cam.camera_position_from_spherical_angles(
        t(distances).reshape(B), t(elevations).reshape(B), t(azimuths).reshape(B))
    tf = cam.generate_transformation_matrix(pos, object_pos, up)
    vc = cam.transform_vertices(t(vertices)[None], tf)
    vi = cam.project_vertices(vc, torch.as_tensor(cam_proj).cpu())
    return vi[0].numpy(), vc[0, :, 2].numpy()


def transfer_via_camera(kps_src, verts, cam_src, cam_tgt, cam_proj, mask_tgt=None):
    """``cam_*`` = (azimuths, elevations, distances, biases) of one example;
    ``mask_tgt`` (H, W) the target's foreground (row 0 at the top) -> (K, 2)
    target xy: each keypoint's nearest projected vertex in the source view,
    then that vertex's nearest foreground pixel in the target view (its
    target projection itself without a mask).  All in the model's NDC
    frame (+y up)."""
    vi_s, _ = project_vertices(verts, *cam_src, cam_proj=cam_proj)
    vi_t, _ = project_vertices(verts, *cam_tgt, cam_proj=cam_proj)
    kps = np.asarray(kps_src)
    kp2proj_idx = ((vi_s[None, :, :] - kps[:, None, :]) ** 2).sum(-1).argmin(axis=1)
    if mask_tgt is None:
        return vi_t[kp2proj_idx]
    mask = np.asarray(mask_tgt)
    H, W = mask.shape
    sg = _sgrid(H, W)
    sg = np.stack([sg[..., 0], -sg[..., 1]], -1)  # the model's frame: +y up
    fg_coords = sg[mask > 0.5]  # (P, 2)
    if fg_coords.shape[0] == 0:
        return vi_t[kp2proj_idx]
    proj2fg_idx = ((vi_t[:, None, :] - fg_coords[None, :, :]) ** 2).sum(-1).argmin(axis=1)
    return fg_coords[proj2fg_idx[kp2proj_idx]]


def pck_errors(pred_kps, gt_kps, padding_frac=0.0):
    """Normalised transfer errors (K,): L2 in the [-1, 1] frame times (1 + 2
    padding_frac) / 2, the error over the bounding box's longest side."""
    err_scaling = (1.0 + 2.0 * padding_frac) / 2.0
    d = np.asarray(pred_kps, np.float64) - np.asarray(gt_kps, np.float64)
    return np.sqrt((d * d).sum(axis=-1)) * err_scaling


def pck_aggregate(errs, vis, alphas=(0.1, 0.15)):
    """``errs`` / ``vis`` (N, K) over the pairs -> {alpha: the mean over
    keypoints of each keypoint's accuracy}."""
    errs = np.asarray(errs, np.float64)
    vis = np.asarray(vis, np.float64)
    n_vis = vis.sum(axis=0)
    valid = n_vis > 0
    out = {}
    for a in alphas:
        correct = ((errs < a) * vis).sum(axis=0)
        out[a] = float((correct[valid] / n_vis[valid]).mean()) if valid.any() else 0.0
    return out


def pck(pred_kps, gt_kps, visible, padding_frac=0.0, alphas=(0.1, 0.15)):
    """PCK at each alpha of one pair over its visible keypoints."""
    d = pck_errors(pred_kps, gt_kps, padding_frac)
    vis = np.asarray(visible, bool)
    return {a: (float((d[vis] < a).mean()) if vis.sum() else 0.0) for a in alphas}
