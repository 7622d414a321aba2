"""The port's bicubic resize (``eval/images.py::resize_bicubic``) against
Pillow's ``Image.resize`` at its default filter, and the port's
``file_metrics`` against the JAX function on files of another size than the
eval's, which both resample.

Tolerances: the resize within 1 of 255 (Pillow's own fixed-point
arithmetic is reproduced, seen: 0 on every case); the file metrics within
1e-6, as tests/test_torch_eval.py holds them on files of the eval size.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from magicmirror.train import trainer as jtrainer
from magicmirror_torch.eval import images
from magicmirror_torch.train import TrainOptions
from magicmirror_torch.train.trainer import file_metrics

torch.set_num_threads(1)


@pytest.mark.parametrize("mode,shape,size", [
    ("RGB", (17, 23), (32, 64)),   # up on both axes
    ("RGB", (128, 64), (24, 48)),  # down: the kernel widens with the scale
    ("RGB", (40, 40), (40, 27)),   # one axis only
    ("L", (23, 17), (100, 37)),    # up and down at once
    ("L", (96, 50), (7, 3)),       # far down
    ("L", (30, 30), (30, 30)),     # the same size: the same array
])
def test_resize_matches_pillow(mode, shape, size):
    rs = np.random.RandomState(sum(shape) + sum(size))
    full = shape + ((3,) if mode == "RGB" else ())
    noisy = rs.randint(0, 256, full).astype(np.uint8)
    ramp = np.linspace(0, 255, noisy.size).reshape(full).astype(np.uint8)
    for arr in (noisy, ramp):
        ref = np.asarray(Image.fromarray(arr, mode).resize(size))
        ours = images.resize_bicubic(arr, size)
        assert ours.dtype == np.uint8 and ours.shape == ref.shape
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_file_metrics_resample_as_the_reference(tmp_path):
    """Files written at two other sizes than the eval size (24 wide, 48 high
    at ratio 2): the JAX function and the port resample each file to it."""
    opt = TrainOptions(imageSize=24, ratio=2.0)
    dirs = tuple(str(tmp_path / d) for d in ("ori", "rec", "inter", "inter90", "ori_mask",
                                               "rec_mask"))
    for d in dirs:
        os.makedirs(d)
    rs = np.random.RandomState(9)
    todo = []
    for i, (h, w) in enumerate(((64, 40), (30, 17))):
        a = rs.rand(h, w, 3).astype(np.float32)
        b = np.clip(a + 0.2 * rs.randn(h, w, 3), 0, 1).astype(np.float32)
        ma, mb = (rs.rand(2, h, w) > 0.4).astype(np.float32)
        name = f"s{i:03d}.png"
        todo += [(a, os.path.join(dirs[0], name)), (b, os.path.join(dirs[1], name)),
                 (ma, os.path.join(dirs[4], name)), (mb, os.path.join(dirs[5], name))]
    images.save_images_parallel(todo)
    ref = jtrainer.file_metrics(opt, dirs)
    ours = file_metrics(opt, dirs, device="cpu")
    assert 0.0 < ref[0] < 1.0 and 0.0 < ref[1] < 1.0
    assert abs(ours[0] - ref[0]) <= 1e-6 and abs(ours[1] - ref[1]) <= 1e-6, (ours, ref)
