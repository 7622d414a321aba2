"""``magicmirror_torch/eval/pck.py`` against ``magicmirror/eval/pck.py``,
number for number, on random inputs: the Gaussian label map (inside, across
and outside the image's borders), both keypoint transfers, the vertex
projection, the errors and the aggregation."""
import numpy as np
import pytest
import torch

from magicmirror.eval import pck as jpck
from magicmirror_torch.eval import pck

torch.set_num_threads(1)
CAM_PROJ = np.array([2.5, 2.5], np.float32)


@pytest.mark.parametrize("pt", [(16.3, 20.7), (1.2, 30.5), (-5.0, 10.0), (40.0, 40.0),
                                (31.9, 0.1)])
def test_draw_labelmap(pt):
    img = np.random.RandomState(0).rand(32, 32).astype(np.float32)
    assert np.array_equal(pck.draw_labelmap(img, pt, 3), jpck.draw_labelmap(img, pt, 3))


def _camera(rs):
    return (rs.uniform(-180, 180, 1).astype(np.float32), rs.uniform(0, 30, 1).astype(np.float32),
            rs.uniform(2, 7, 1).astype(np.float32),
            rs.uniform(-0.3, 0.3, (1, 2)).astype(np.float32))


def test_project_vertices_and_the_camera_transfer():
    rs = np.random.RandomState(1)
    verts = (rs.rand(60, 3) - 0.5).astype(np.float32)
    cam_a, cam_b = _camera(rs), _camera(rs)
    for ours, ref in zip(pck.project_vertices(verts, *cam_a, cam_proj=CAM_PROJ),
                         jpck.project_vertices(verts, *cam_a, cam_proj=CAM_PROJ)):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    kps = rs.uniform(-1, 1, (15, 2)).astype(np.float32)
    mask = np.zeros((32, 32), np.float32)
    mask[6:28, 9:25] = 1.0
    for m in (mask, None, np.zeros_like(mask)):
        ours = pck.transfer_via_camera(kps, verts, cam_a, cam_b, CAM_PROJ, mask_tgt=m)
        ref = jpck.transfer_via_camera(kps, verts, cam_a, cam_b, CAM_PROJ, mask_tgt=m)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("flow_kind", ["faces", "grid"])
def test_the_texture_flow_transfer(flow_kind):
    rs = np.random.RandomState(2)
    if flow_kind == "faces":
        flows = [rs.uniform(-1, 1, (40, 6, 2)).astype(np.float32) for _ in range(2)]
    else:
        flows = [rs.uniform(-1, 1, (8, 12, 2)).astype(np.float32) for _ in range(2)]
    kps = rs.uniform(-0.9, 0.9, (7, 2)).astype(np.float32)
    ours = pck.transfer_via_texture_flow(kps, *flows, image_size=32, sigma=2)
    ref = jpck.transfer_via_texture_flow(kps, *flows, image_size=32, sigma=2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_errors_aggregation_and_pck():
    rs = np.random.RandomState(3)
    pred, gt = rs.uniform(-1, 1, (2, 15, 2))
    for frac in (0.0, 0.1):
        assert np.array_equal(pck.pck_errors(pred, gt, frac), jpck.pck_errors(pred, gt, frac))
    vis = rs.rand(15) < 0.7
    assert pck.pck(pred, gt, vis) == jpck.pck(pred, gt, vis)
    assert pck.pck(pred, gt, np.zeros(15, bool)) == jpck.pck(pred, gt, np.zeros(15, bool))
    errs = rs.uniform(0, 0.3, (9, 15))
    vis = (rs.rand(9, 15) < 0.6).astype(np.float64)
    vis[:, 3] = 0.0  # a keypoint never visible
    assert pck.pck_aggregate(errs, vis) == jpck.pck_aggregate(errs, vis)
    assert pck.pck_aggregate(errs, 0 * vis) == jpck.pck_aggregate(errs, 0 * vis)
