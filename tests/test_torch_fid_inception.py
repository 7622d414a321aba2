"""The port's FID Inception (magicmirror_torch/eval/inception.py) against
tests/torch_fid_ref.py, which tests/test_fid_parity.py holds to the Flax
model: random pytorch-fid-named weights go through the JAX package's
converter (``magicmirror/eval/convert_fid_weights.py``) into the port's
loader.  Tolerances: activations within 1e-5 of the largest (the same torch
operations; seen 0); the FID of two written image sets within 1e-3
relative of the one computed from the reference's activations.

Slow (InceptionV3 at 299^2 on the CPU), and one test function on purpose:
under ``pytest -n 6 --dist loadfile`` the files with the most tests are
handed out first, so a slow file with few tests runs beside the suite's long
files and not ahead of them.
"""
import os

import numpy as np
import torch

from magicmirror.eval import fid as jfid
from magicmirror.eval.convert_fid_weights import convert
from magicmirror_torch.eval import fid, images
from magicmirror_torch.eval.inception import load_fid_weights
from torch_fid_ref import TorchFIDInceptionV3
from torch_parity import n, t

torch.set_num_threads(1)


def test_inception_matches_the_torch_reference_on_converted_weights(tmp_path):
    """Random pytorch-fid-named weights -> the converter's npz -> the port's
    loader; activations equal the reference network's (which
    tests/test_fid_parity.py holds to the Flax model), and the FID of two
    written image sets equals the one computed from the reference's
    activations."""
    torch.manual_seed(0)
    ref = TorchFIDInceptionV3().eval()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.02)
                m.running_var.uniform_(0.8, 1.2)
    path = str(tmp_path / "w.npz")
    np.savez(path, **convert(ref.state_dict()))
    model = load_fid_weights(path, device="cpu")
    x = np.random.RandomState(8).rand(2, 40, 32, 3).astype(np.float32)
    with torch.no_grad():
        want = ref(t(x).permute(0, 3, 1, 2)).numpy()
        got = n(model(t(x).permute(0, 3, 1, 2)))
    assert got.shape == (2, 2048)
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)

    rs = np.random.RandomState(9)
    dirs, acts = [], []
    for d, scale in (("a", 1.0), ("b", 0.6)):
        os.makedirs(tmp_path / d)
        imgs = (rs.rand(4, 24, 24, 3) * 255 * scale).astype(np.uint8)
        for i, im in enumerate(imgs):
            images.save_array_image(im / 255.0, str(tmp_path / d / f"{i}.png"))
        with torch.no_grad():
            acts.append(ref(torch.as_tensor(imgs).permute(0, 3, 1, 2).float() / 255.0).numpy())
        dirs.append(str(tmp_path / d))
    want = jfid.calculate_frechet_distance(acts[0].mean(0), np.cov(acts[0], rowvar=False),
                                           acts[1].mean(0), np.cov(acts[1], rowvar=False))
    got = fid.calculate_fid_given_paths(dirs, batch_size=3, model=model)
    assert abs(got - want) <= 1e-3 * abs(want), (got, want)
