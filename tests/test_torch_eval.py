"""The port's eval modules against the JAX package's (magicmirror_torch/eval
vs magicmirror/eval): the metrics, the file metrics over the same written
files, the Frechet distance, the FID Inception, and the port's own PNG and
GIF codecs against Pillow.  The FID Inception is held in
tests/test_torch_fid_inception.py.

Tolerances: SSIM, mask-IoU and the normal MSE within 1e-6 (float32 on both
sides; the SSIM window filter is a float32 convolution in both); the file
metrics within 1e-6; the Frechet distance within 1e-9 relative (the same
float64 numpy and scipy code); the PNG and GIF codecs exactly.
"""
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from magicmirror.eval import fid as jfid
from magicmirror.eval import metrics as jmetrics
from magicmirror.train import trainer as jtrainer
from magicmirror_torch.eval import fid, images, metrics
from magicmirror_torch.eval.gifs import PALETTE, palette_indices, write_gif
from magicmirror_torch.render.synthetic import smooth_random
from magicmirror_torch.train import TrainOptions
from magicmirror_torch.train.trainer import file_metrics
from torch_parity import t

torch.set_num_threads(1)


def _pair(seed, shape=(2, 24, 20, 3)):
    rs = np.random.RandomState(seed)
    a = rs.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.2 * rs.randn(*shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_matches_reference(seed):
    a, b = _pair(seed)
    ref = float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(metrics.ssim(t(a), t(b))) - ref) <= 1e-6
    assert abs(float(metrics.ssim(t(a), t(a))) - 1.0) <= 1e-6


def test_mask_iou_and_normal_mse_match_reference():
    rs = np.random.RandomState(2)
    p, g = rs.rand(2, 3, 16, 16).astype(np.float32)
    assert abs(float(metrics.mask_iou_metric(t(p), t(g)))
               - float(jmetrics.mask_iou_metric(jnp.asarray(p), jnp.asarray(g)))) <= 1e-6
    x, y = rs.rand(2, 2, 8, 8, 3).astype(np.float32)
    m = (rs.rand(2, 8, 8) > 0.5).astype(np.float32)
    for mask in (None, m):
        ref = float(jmetrics.normal_mse(jnp.asarray(x), jnp.asarray(y),
                                        None if mask is None else jnp.asarray(mask)))
        ours = float(metrics.normal_mse(t(x), t(y), None if mask is None else t(mask)))
        assert abs(ours - ref) <= 1e-6


@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 3), (64, 48, 3)])
def test_png_round_trips_exactly(shape):
    a = (np.random.RandomState(3).rand(*shape) * 255).astype(np.uint8)
    blob = images.encode_png(a)
    assert np.array_equal(images.decode_png(blob), a)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(blob))), a)  # Pillow reads it


def _filtered_png(a, kind):
    """A PNG of ``a`` whose every row carries filter ``kind`` (0-4), written
    by the PNG standard's filter definitions."""
    import struct
    import zlib

    h = a.shape[0]
    bpp = 1 if a.ndim == 2 else a.shape[2]
    rows = a.reshape(h, -1).astype(np.int32)
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for row in rows:
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [np.zeros_like(row), left, prev, (left + prev) // 2,
                images._paeth(left, prev, up_left)][kind]
        out.append(np.concatenate([[kind], (row - pred) % 256]).astype(np.uint8))
        prev = row
    header = struct.pack(">IIBBBBB", a.shape[1], h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    return (images._PNG_SIGNATURE + images._png_chunk(b"IHDR", header)
            + images._png_chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + images._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_reader_takes_every_row_filter(kind):
    a = (np.random.RandomState(kind).rand(9, 11, 3) * 255).astype(np.uint8)
    blob = _filtered_png(a, kind)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(blob))), a)  # a valid PNG
    assert np.array_equal(images.decode_png(blob), a)


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_png_reader_reads_what_pillow_writes(mode, tmp_path):
    yy, xx = np.mgrid[:40, :56]
    rgb = np.stack([(xx * 5) % 256, (yy * xx) % 256, (yy * 3 + xx) % 256], -1).astype(np.uint8)
    img = Image.fromarray(rgb).convert(mode)
    for kw in ({}, {"optimize": True}, {"compress_level": 1}):
        path = str(tmp_path / "p.png")
        img.save(path, **kw)
        assert np.array_equal(images.read_image(path), np.asarray(img)), kw
    # the reader's conversions are Pillow's
    path = str(tmp_path / "rgb.png")
    Image.fromarray(rgb).save(path)
    assert np.array_equal(images.read_image(path, "L"), np.asarray(Image.open(path).convert("L")))
    assert np.array_equal(images.read_image(str(tmp_path / "p.png"), "RGB"),
                          np.asarray(img.convert("RGB")))


def test_jpeg_goes_through_pillow(tmp_path):
    """A .jpg name is the JAX package's JPEG: Pillow's at quality 100."""
    a = smooth_random((1, 16, 16, 3), 4)[0]
    path, ref = str(tmp_path / "x.jpg"), str(tmp_path / "ref.jpg")
    images.save_array_image(a, path)
    Image.fromarray(images.to_uint8(a)).save(ref, "JPEG", quality=100)
    assert open(path, "rb").read() == open(ref, "rb").read()
    assert np.array_equal(images.read_image(path), np.asarray(Image.open(ref)))


def test_gif_frames_decode_in_pillow(tmp_path):
    rs = np.random.RandomState(5)
    # a noisy frame fills the LZW table several times over
    frames = [(rs.rand(120, 150, 3) * 255).astype(np.uint8),
              np.full((120, 150, 3), 255, np.uint8)]
    path = str(tmp_path / "a.gif")
    write_gif(path, frames)
    gif = Image.open(path)
    assert gif.n_frames == 2
    for i, frame in enumerate(frames):
        gif.seek(i)
        assert np.array_equal(np.asarray(gif.convert("RGB")), PALETTE[palette_indices(frame)])
    assert tuple(PALETTE[palette_indices(frames[1])][0, 0]) == (255, 255, 255)


def test_file_metrics_match_reference(tmp_path):
    """The JAX trainer's file_metrics (Pillow reads) and the port's (its own
    PNG reader) over the same written files."""
    S = 24
    opt = TrainOptions(imageSize=S)
    dirs = tuple(str(tmp_path / d) for d in ("ori", "rec", "inter", "inter90", "ori_mask",
                                               "rec_mask"))
    for d in dirs:
        os.makedirs(d)
    rs = np.random.RandomState(6)
    todo = []
    for i in range(3):
        a, b = _pair(10 + i, (1, S, S, 3))
        ma, mb = (rs.rand(2, S, S) > 0.4).astype(np.float32)
        name = f"s{i:03d}.png"
        todo += [(a[0], os.path.join(dirs[0], name)), (b[0], os.path.join(dirs[1], name)),
                 (ma, os.path.join(dirs[4], name)), (mb, os.path.join(dirs[5], name))]
    images.save_images_parallel(todo)
    ref = jtrainer.file_metrics(opt, dirs)
    ours = file_metrics(opt, dirs, device="cpu")
    assert 0.0 < ref[0] < 1.0 and 0.0 < ref[1] < 1.0
    assert abs(ours[0] - ref[0]) <= 1e-6 and abs(ours[1] - ref[1]) <= 1e-6, (ours, ref)


def test_frechet_distance_matches_reference():
    rs = np.random.RandomState(7)
    a, b = rs.randn(40, 16), rs.randn(50, 16) * 1.3 + 0.2
    stats = [(x.mean(0), np.cov(x, rowvar=False)) for x in (a, b)]
    ref = jfid.calculate_frechet_distance(*stats[0], *stats[1])
    ours = fid.calculate_frechet_distance(*stats[0], *stats[1])
    assert abs(ours - ref) <= 1e-9 * abs(ref) and ref > 0
    # fewer samples than dimensions: the singular case and its eps retry
    a, b = rs.randn(6, 16), rs.randn(6, 16)
    stats = [(x.mean(0), np.cov(x, rowvar=False)) for x in (a, b)]
    assert abs(fid.calculate_frechet_distance(*stats[0], *stats[1])
               - jfid.calculate_frechet_distance(*stats[0], *stats[1])) <= 1e-6
