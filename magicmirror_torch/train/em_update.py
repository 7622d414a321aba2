"""The EM template update, the port of ``magicmirror/train/em_update.py``:
an encode sweep over the no-augmentation train set (on the encoder's
device), then on the host the choice of samples (``select_delta``) and the
smoothed, clipped step of the template (``apply_template_update``), numpy
line for line as the JAX package has them.  ``em = 4`` clusters with DBSCAN,
written here in numpy (``dbscan_labels``) with scikit-learn's semantics."""
from __future__ import annotations

import numpy as np
import torch

from ..serve import _no_tf32


@_no_tf32()
@torch.no_grad()
def encode_sweep(netE, images, template, lpl, white: bool):
    """Eval-mode encode of ``images`` (B, H, W, 4) -> (vertices, delta)
    (B, V, 3), both re-centred per sample when ``white``."""
    was_training = netE.training
    netE.eval()
    try:
        att = netE(images, template, lpl)
    finally:
        netE.train(was_training)
    vertices, delta = att["vertices"], att["delta_vertices"]
    if white:
        vertices = vertices - vertices.mean(dim=1, keepdim=True)
        delta = delta - delta.mean(dim=1, keepdim=True)
    return vertices, delta


def dbscan_labels(dist: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN on a precomputed distance matrix, as scikit-learn's
    ``DBSCAN(metric="precomputed")`` labels it: neighbours within ``eps``
    (itself included), core points with at least ``min_samples`` of them,
    clusters grown depth-first from the core points in index order, -1 for
    noise."""
    n = dist.shape[0]
    neighbours = [np.flatnonzero(dist[i] <= eps) for i in range(n)]
    core = np.array([len(nb) >= min_samples for nb in neighbours])
    labels = np.full(n, -1, np.int64)
    label = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        stack = []
        while True:
            if labels[i] == -1:
                labels[i] = label
                if core[i]:
                    stack.extend(int(v) for v in neighbours[i] if labels[v] == -1)
            if not stack:
                break
            i = stack.pop()
        label += 1
    return labels


def select_delta(all_vertices: np.ndarray, all_delta: np.ndarray, opt, num_vertices: int):
    """Host-side subset selection -> (sum_delta (V, 3), count)."""
    sample_number = all_vertices.shape[0]

    # drop collapsed samples: the reference thresholds the LAST vertex's mean
    # |delta| (it indexes [:, -1] on an (N, V, 3) tensor)
    mean_delta = np.abs(all_delta)[:, -1].mean(axis=1)
    keep = mean_delta <= 0.4
    all_vertices = all_vertices[keep]
    all_delta = all_delta[keep]
    n = all_vertices.shape[0]
    print("Extreme Bad Case: %d" % (sample_number - n))
    if n == 0:
        return np.zeros((num_vertices, 3), np.float32), 0

    em = opt.em
    if em == 2:  # only positive mean depth
        good = all_vertices[:, :, 2].mean(axis=1) >= 0.001
        return all_delta[good].sum(axis=0), int(good.sum())
    if em == 3:  # left/right + front/back symmetry counts
        left = (all_vertices[:, :, 0] > 0).sum(axis=1)
        front = (all_vertices[:, :, 2] > 0).sum(axis=1)
        g1 = np.abs(left - num_vertices // 2) < int(num_vertices * 0.1)
        g2 = np.abs(front - num_vertices // 2) < int(num_vertices * 0.1)
        good = g1 & g2
        return all_delta[good].sum(axis=0), int(good.sum())
    if em == 4:  # DBSCAN cluster on whitened L2-normalized shapes
        flat = all_vertices.reshape(n, -1).astype(np.float64)
        flat -= flat.mean(axis=1, keepdims=True)
        flat /= flat.std(axis=1, ddof=1, keepdims=True) + 1e-12
        flat /= np.linalg.norm(flat, axis=1, keepdims=True) + 1e-8
        sim = np.clip(flat @ flat.T, None, 1.0)
        dist = 2.0 - 2.0 * sim
        labels = dbscan_labels(dist, opt.eps, max(int(n * 0.1), 1))
        valid = labels[labels != -1]
        if len(valid) > 0:
            vals, counts = np.unique(valid, return_counts=True)
            best = vals[np.argmax(counts)]
            good = labels == best
            print("Cluster %d is selected!" % best)
            return all_delta[good].sum(axis=0), int(good.sum())
        print("No good clusters are found! Use all data to update.")
        return all_delta.sum(axis=0), n
    if em == 5:  # top-K smallest deformation
        d = (all_delta.reshape(n, -1) ** 2).sum(axis=1)
        order = np.argsort(d)
        good = order[: int(n * opt.topK)]
        return all_delta[good].sum(axis=0), len(good)
    # default: all-sample mean
    return all_delta.sum(axis=0), n


def apply_template_update(template: np.ndarray, sum_delta: np.ndarray, count: int,
                          laplacian: np.ndarray, warm_up: float, em_step: float,
                          opt) -> tuple[np.ndarray, float]:
    """Smooth, clip, step, re-centre, cross-check -> (new_template,
    new_em_step)."""
    if count <= 1:
        return template, em_step
    delta = sum_delta / count
    if opt.smooth > 0:
        delta = delta + (laplacian @ delta) * opt.smooth
        if opt.em >= 6:
            for _ in range(int(opt.em - 5)):
                delta = delta + (laplacian @ delta) * opt.smooth
    delta = np.clip(delta, -opt.clip, opt.clip)
    new_template = template + warm_up * em_step * delta
    if opt.white:
        new_template = new_template - new_template.mean(axis=0, keepdims=True)
    # z-sign cross check: roll back if any vertex crossed the z=0 plane
    cross = np.sum(np.maximum(-np.sign(new_template[:, 2]) * np.sign(template[:, 2]), 0.0))
    print("whether_cross:%f" % cross)
    if cross > 0 and opt.cross:
        new_template = template
    return new_template.astype(np.float32), em_step * 0.99
