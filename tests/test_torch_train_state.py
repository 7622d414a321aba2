"""The trainer's host logic against the JAX package's
(magicmirror_torch/train vs magicmirror/train): the EM pieces
(``select_delta``, ``apply_template_update``), the numpy DBSCAN against
scikit-learn's, the ``train_shape`` policy and the warm-up.  All exact: the
same numpy code, the same rules.  ``swa_update`` and ``encode_sweep`` are
held to the JAX package in tests/test_torch_swa_encode.py, the checkpoint
round trip in tests/test_torch_trainer_run.py.
"""
import types

import numpy as np
import pytest

from magicmirror.train import em_update as jem
from magicmirror.train import trainer as jtrainer
from magicmirror_torch.train import em_update as tem
from magicmirror_torch.train import trainer as ttrainer


@pytest.mark.parametrize("em", [1, 2, 3, 4, 5, 7])
def test_select_delta_and_template_update_match_reference(em):
    rs = np.random.RandomState(em)
    N, V = 40, 50
    verts = rs.randn(N, V, 3).astype(np.float32) * 0.5
    verts[: N // 2] += 0.8  # two clusters for DBSCAN
    delta = (rs.randn(N, V, 3) * 0.2).astype(np.float32)
    delta[:3, -1] = 0.9  # collapsed samples
    opt = types.SimpleNamespace(em=em, eps=0.2, topK=0.2, smooth=0.5, clip=0.05, white=True,
                                cross=em == 3)
    ref = jem.select_delta(verts, delta, opt, V)
    ours = tem.select_delta(verts, delta, opt, V)
    assert ours[1] == ref[1] and np.array_equal(ours[0], ref[0])
    template = (rs.randn(V, 3) * 0.5).astype(np.float32)
    lap = rs.randn(V, V).astype(np.float32) * 0.1
    for count in (ref[1], 1):
        want = jem.apply_template_update(template, ref[0], count, lap, 0.7, 0.1, opt)
        got = tem.apply_template_update(template, ref[0], count, lap, 0.7, 0.1, opt)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_dbscan_matches_scikit_learn():
    from sklearn.cluster import DBSCAN

    for seed in range(12):
        rs = np.random.RandomState(seed)
        pts = np.concatenate([rs.randn(15, 3) * 0.3, rs.randn(20, 3) * 0.3 + 2])
        dist = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
        eps, min_samples = rs.uniform(0.2, 1.0), rs.randint(1, 6)
        want = DBSCAN(eps=eps, min_samples=min_samples, metric="precomputed").fit(dist).labels_
        assert np.array_equal(tem.dbscan_labels(dist, eps, min_samples), want), seed


def test_train_shape_policy_and_warm_up():
    for update_shape in (-1, 0, 1, 3):
        opt = types.SimpleNamespace(update_shape=update_shape)
        assert ([ttrainer._train_shape_policy(opt, it) for it in range(12)]
                == [jtrainer._train_shape_policy(opt, it) for it in range(12)])
    # the JAX trainer's warm-up: from 0.01, +0.99 / warm_iteration an
    # iteration while epoch < warm_epoch, at most 1
    opt = types.SimpleNamespace(warm_epoch=2)
    iters = 3
    warm, seq = 0.01, []
    for epoch in range(4):
        for _ in range(iters):
            warm = ttrainer._warm_up(warm, epoch, opt, iters * opt.warm_epoch)
            seq.append(warm)
    want = [min(1.0, 0.01 + 0.99 / 6 * (i + 1)) for i in range(6)] + [seq[5]] * 6
    assert seq == want and abs(seq[5] - 1.0) <= 1e-12
