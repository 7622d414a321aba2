"""The eval CLIs' helpers: several FIDs against one reference directory
(``eval/fid.py::fids_against``: the reference's statistics once, the
distances in processes of their own), the histograms' npz
(``save_histograms``, against the JAX package's), ``serve_options`` from
parsed flags, and PNGs with an alpha channel (``eval/images.read_image``
and ``encode_png``, against Pillow)."""
import argparse
import os

import numpy as np
import pytest
import torch
from PIL import Image

from magicmirror.configs.flags import build_parser as jbuild_parser
from magicmirror.eval.reports import save_histograms as jsave_histograms
from magicmirror_torch.eval.fid import calculate_fid_given_paths, fids_against
from magicmirror_torch.eval.images import encode_png, read_image, save_array_image
from magicmirror_torch.eval.reports import save_histograms
from magicmirror_torch.serve import ServeOptions, serve_options

torch.set_num_threads(1)


class TinyFeatures(torch.nn.Module):
    """Stands for the Inception: 8 features an image (an 8 x 8 covariance)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3)
        torch.nn.init.normal_(self.conv.weight, generator=torch.Generator().manual_seed(0))

    def forward(self, x):
        return torch.tanh(self.conv(x)).mean(dim=(2, 3))


def test_fids_against_one_reference_are_the_pairwise_fids(tmp_path):
    rs = np.random.RandomState(0)
    dirs = []
    for k, shift in enumerate((0.0, 0.1, 0.3)):
        d = tmp_path / f"d{k}"
        d.mkdir()
        for i in range(12):
            save_array_image(np.clip(rs.rand(16, 16, 3) * 0.8 + shift, 0, 1),
                             str(d / f"{i}.png"))
        dirs.append(str(d))
    model = TinyFeatures()
    pairwise = [calculate_fid_given_paths([dirs[0], d], 4, model=model) for d in dirs[1:]]
    assert pairwise[0] < pairwise[1]
    # one distance in this process, two at once in processes of their own
    for some in (dirs[1:2], dirs[1:]):
        got = fids_against(dirs[0], some, 4, model=model)
        np.testing.assert_allclose(got, pairwise[:len(some)], rtol=1e-9, atol=0)
    with pytest.raises(RuntimeError, match="Invalid path"):
        fids_against(dirs[0], [str(tmp_path / "nowhere")], model=model)


def test_histograms_npz_as_the_jax_package_writes_it(tmp_path):
    rs = np.random.RandomState(1)
    stats = {"azimuths": rs.uniform(-180, 180, 9), "bias_x": rs.randn(9).astype(np.float32),
             "empty": np.zeros(0)}
    save_histograms(stats, str(tmp_path / "ours.png"))
    jsave_histograms(stats, str(tmp_path / "ref.png"))
    ours, ref = (np.load(tmp_path / f"{k}.png.npz") for k in ("ours", "ref"))
    assert sorted(ours.files) == sorted(ref.files) == sorted(stats)
    for key in stats:
        assert np.array_equal(ours[key], ref[key]) and ours[key].dtype == ref[key].dtype
    assert os.path.isfile(tmp_path / "ours.png")  # matplotlib is here


def test_serve_options_from_the_parsed_flags():
    argv = ["--imageSize", "64", "--ratio", "2", "--soft_mode", "exact", "--bg",
            "--lambda_data", "2", "--name", "x"]
    ns = jbuild_parser().parse_args(argv)
    opt = serve_options(ns)
    assert (opt.imageSize, opt.ratio, opt.soft_mode, opt.bg) == (64, 2.0, "exact", True)
    assert serve_options(jbuild_parser().parse_args([])) == ServeOptions()
    for bad in (["--pretrainc", "res18"], ["--pretrains", "res50"], ["--pretraint", "swin"]):
        with pytest.raises(NotImplementedError):
            serve_options(jbuild_parser().parse_args(bad))
    # the encoder options a run was trained with are served
    opt = serve_options(jbuild_parser().parse_args(["--norm", "in", "--makeup", "1", "--nolpl",
                                                    "--lambda_lc", "0.1"]))
    assert (opt.norm, opt.makeup, opt.nolpl, opt.lambda_lc) == ("in", 1, True, 0.1)
    # a namespace of opts.yaml's keys alone
    assert serve_options(argparse.Namespace(imageSize=32)).imageSize == 32


@pytest.mark.parametrize("mode", ["RGBA", "LA", "RGB", "L"])
def test_png_with_and_without_alpha_reads_as_pillow_converts_it(tmp_path, mode):
    rs = np.random.RandomState(2)
    shape = (21, 13) + ((len(mode),) if len(mode) > 1 else ())
    arr = (rs.rand(*shape) * 255).astype(np.uint8)
    Image.fromarray(arr, mode).save(tmp_path / "a.png")
    with Image.open(tmp_path / "a.png") as im:
        assert np.array_equal(read_image(str(tmp_path / "a.png")), np.asarray(im))
        for m in ("RGB", "L"):
            assert np.array_equal(read_image(str(tmp_path / "a.png"), m), np.asarray(im.convert(m)))
    (tmp_path / "b.png").write_bytes(encode_png(arr))  # and the port's own writer
    with Image.open(tmp_path / "b.png") as im:
        assert im.mode == mode and np.array_equal(np.asarray(im), arr)
