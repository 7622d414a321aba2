"""The port's demo and metric CLIs against the JAX package's, on the CPU, on
one tree and one checkpoint (the JAX package's, converted:
``torch_parity.jax_run`` / ``port_run``), the random views injected:

  * ``single_img``: ``preprocess`` (with the ``salt`` and ``blur``
    corruptions) equal to the JAX function's; the panel, captured before it
    is written, and the rotation GIF's frames to the slice's tolerances;
  * ``show_camera``: its npz;
  * ``show_rainbow2``: the grids, the texture and the mesh; the frames of
    every GIF (the rainbow, the bias and the three sweeps), counted and held
    within 3 of 255 (the renders' 1e-2 and the rounding);
  * ``test_cub30``: the photos and the 12 bins' renders (FID stubbed);
  * ``test_thu``: the items of a THuman2 tree, and the normal MSE to 1e-5;
  * ``test_pck``: PCK at 0.1 and 0.15 over a tiny keypoint file.

The JAX CLIs' eager renders and encoder run jitted here (the same
functions, one XLA program each) and their state is restored into zeros of
its structure: each is minutes eager on the CPU.  Two test functions: the
file compiles JAX eval steps (ROADMAP §1 rules).
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import magicmirror.cli.show_camera as jcamera
import magicmirror.cli.show_rainbow2 as jrainbow
import magicmirror.cli.single_img as jsingle
import magicmirror.cli.test as jtest
import magicmirror.cli.test_cub30 as jcub30
import magicmirror.cli.test_pck as jpck
import magicmirror.cli.test_thu as jthu
import magicmirror_torch.cli.show_rainbow2 as prainbow
import magicmirror_torch.cli.single_img as psingle
import magicmirror_torch.cli.test_cub30 as pcub30
import magicmirror_torch.eval.gifs as pgifs
from magicmirror.data.thuman2 import THuman2Dataset as JTHuman2Dataset
from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror_torch import kernels, parity
from magicmirror_torch.cli import show_camera as pcamera
from magicmirror_torch.cli import test_pck as ppck
from magicmirror_torch.cli import test_thu as pthu
from magicmirror_torch.data import THuman2Dataset
from test_torch_data import cub_tree
from torch_parity import jax_run, port_run, zeros_train_state

torch.set_num_threads(1)
NAME = "clitest"


class JitRender(JDiffRender):
    """The JAX renderer with ``render`` under ``jax.jit``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._jitted = jax.jit(lambda att: JDiffRender.render(self, **att))

    def render(self, **att):
        return self._jitted(att)


class JitApply:
    """A Flax module whose ``apply`` runs under ``jax.jit``."""

    def __init__(self, module):
        self.module = module
        self.apply = jax.jit(module.apply, static_argnames=("train_shape", "train"))

    def __getattr__(self, name):
        return getattr(self.module, name)


class GifWriter:
    """Stands for ``imageio.get_writer``: keeps the frames."""

    def __init__(self, frames, path):
        self.frames = frames.setdefault(os.path.basename(path), [])

    def append_data(self, frame):
        self.frames.append(np.asarray(frame))

    def close(self):
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree = cub_tree(tmp_path_factory.mktemp("cub"))
    jroot, proot = (str(tmp_path_factory.mktemp(k)) for k in ("jax", "port"))
    jax_run(jroot, dataroot=tree)
    port_run(jroot, proot)
    yield tree, jroot, proot
    for root in (jroot, proot):  # two runs' checkpoints, over a GB
        shutil.rmtree(root, ignore_errors=True)


@pytest.fixture
def jax_fast(monkeypatch):
    """The JAX CLIs' state restored into zeros of its structure, their
    renderers and encoders jitted, their GIF frames kept -> the frames."""
    import imageio

    frames = {}
    monkeypatch.setattr(jtest, "create_train_state", zeros_train_state)
    for module in (jsingle, jrainbow, jcamera, jcub30, jthu, jpck):
        monkeypatch.setattr(module, "DiffRender", JitRender)
    build = jsingle.build_models
    monkeypatch.setattr(jsingle, "build_models",
                        lambda opt, dr: (lambda e, d: (JitApply(e), d))(*build(opt, dr)))
    monkeypatch.setattr(imageio, "get_writer", lambda path, mode="I": GifWriter(frames, path))
    return frames


def _capture(monkeypatch, module, name, store, call=True):
    """Record the first argument of ``module.name`` by the file name."""
    real = getattr(module, name)

    def capture(arr, path, *args, **kwargs):
        store[os.path.basename(path)] = np.asarray(arr)
        if call:
            real(arr, path, *args, **kwargs)

    monkeypatch.setattr(module, name, capture)


def _gif_frames(monkeypatch, frames):
    """The port's GIF frames, by file name."""
    real = pgifs.write_gif

    def capture(path, fs, *args, **kwargs):
        frames[os.path.basename(path)] = [np.asarray(f) for f in fs]
        real(path, fs, *args, **kwargs)

    for module in (pgifs, prainbow, psingle):
        monkeypatch.setattr(module, "write_gif", capture)


def _check_rgb(ref, ours):
    """(N, H, W, 3) renders to the slice's rgb tolerances."""
    a, b = (np.zeros(np.shape(ref)[:-1] + (4,), np.float32) for _ in range(2))
    a[..., :3], b[..., :3] = ref, ours
    parity.check_renders(parity.render_stats([a], [b]))


def _check_frames(ref, ours):
    assert sorted(ref) == sorted(ours)
    for name in ref:
        assert len(ref[name]) == len(ours[name]), name
        for a, b in zip(ref[name], ours[name]):
            assert a.shape == b.shape, name
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 3, name


def _in(root, monkeypatch, fn, *args, **kwargs):
    monkeypatch.chdir(root)
    return fn(*args, **kwargs)


def test_single_img_show_camera_and_show_rainbow2(runs, jax_fast, monkeypatch):
    tree, jroot, proot = runs
    photo = os.path.join(tree, "test", "c0", "s1.jpg")
    mask = os.path.join(tree, "test", "c0", next(
        f for f in sorted(os.listdir(os.path.join(tree, "test", "c0"))) if f.startswith("s1_")))
    for corrupt in ("none", "salt", "blur"):
        for square in (True, False):
            ref = jsingle.preprocess(photo, mask, 32, 1.0, corrupt=corrupt, square=square)
            ours = psingle.preprocess(photo, mask, 32, 1.0, corrupt=corrupt, square=square)
            assert np.array_equal(ours, ref), (corrupt, square)
    launches = dict(kernels.LAUNCHES)

    # single_img with the salted mask: the panel and the rotation GIF's frames
    argv = ["--name", NAME, "--img", photo, "--mask", mask, "--corrupt", "salt"]
    jpanel, ppanel, pframes = {}, {}, {}
    _capture(monkeypatch, jsingle, "save_array_image", jpanel)
    _capture(monkeypatch, psingle, "save_array_image", ppanel)
    _gif_frames(monkeypatch, pframes)
    _in(jroot, monkeypatch, jsingle.main, argv)
    out = _in(proot, monkeypatch, psingle.main, argv, device="cpu")
    assert set(jpanel) == set(ppanel) == {"s1_panel.png"}
    ref, ours = jpanel["s1_panel.png"], ppanel["s1_panel.png"]
    assert ours.shape == ref.shape == (32, 6 * 32, 3)
    assert np.array_equal(ours[:, :32], ref[:, :32])  # the photo
    _check_rgb(ref.reshape(32, 6, 32, 3).transpose(1, 0, 2, 3),
               ours.reshape(32, 6, 32, 3).transpose(1, 0, 2, 3))
    _check_frames({"s1_rotation.gif": jax_fast["s1_rotation.gif"]}, pframes)
    assert len(pframes["s1_rotation.gif"]) == 36 and os.path.isfile(out["gif"])

    # show_camera: the histogram's values
    _in(jroot, monkeypatch, jcamera.main, ["--name", NAME, "--dataroot", tree])
    _in(proot, monkeypatch, pcamera.main, ["--name", NAME, "--dataroot", tree], device="cpu")
    hist = [np.load(os.path.join(r, "log", NAME, "camera_hist.png.npz")) for r in (jroot, proot)]
    assert sorted(hist[0].files) == sorted(hist[1].files) == sorted(
        ["azimuths", "elevations", "distances", "bias_x", "bias_y"])
    for key in hist[0].files:
        d = hist[1][key] - hist[0][key]
        d = (d + 180.0) % 360.0 - 180.0 if key == "azimuths" else d
        tol = parity.SLICE_TOL["angle_deg" if key in ("azimuths", "elevations") else "attr"]
        assert d.shape == (4,) and np.abs(d).max() <= tol, key

    # show_rainbow2: grids, texture, mesh, and every GIF's frames
    jgrids, pgrids, jmesh, pmesh = {}, {}, {}, {}
    for module, grids, mesh in ((jrainbow, jgrids, jmesh), (prainbow, pgrids, pmesh)):
        _capture(monkeypatch, module, "save_image_grid", grids)
        _capture(monkeypatch, module, "save_array_image", grids)
        monkeypatch.setattr(module, "save_mesh", lambda path, v, *a, store=mesh: store.update(
            {os.path.basename(path): np.asarray(v)}))
    jax_fast.clear()
    pframes.clear()
    argv = ["--name", NAME, "--dataroot", tree]
    _in(jroot, monkeypatch, jrainbow.main, argv)
    draws = np.array(-jax.random.uniform(jax.random.PRNGKey(0), (8,), minval=-180, maxval=180))
    _in(proot, monkeypatch, prainbow.main, argv, device="cpu", draws=draws)
    assert kernels.LAUNCHES == launches  # CPU tensors never reach a kernel
    assert sorted(jgrids) == sorted(pgrids) == [
        "rainbow_Xa.png", "rainbow_Xer.png", "rainbow_Xir.png", "rainbow_texture.png"]
    assert np.array_equal(pgrids["rainbow_Xa.png"], jgrids["rainbow_Xa.png"])
    for name in ("rainbow_Xer.png", "rainbow_Xir.png"):
        _check_rgb(jgrids[name][None], pgrids[name][None])
    d = np.abs(pgrids["rainbow_texture.png"] - jgrids["rainbow_texture.png"])
    assert (d <= parity.SLICE_TOL["attr"]).mean() >= parity.SLICE_TOL["frac"]
    assert d.max() <= parity.SLICE_TOL["textures_max"]
    assert np.abs(pmesh["rainbow_mesh.obj"] - jmesh["rainbow_mesh.obj"]).max() <= 1e-3
    _check_frames(jax_fast, pframes)
    assert {k: len(v) for k, v in pframes.items()} == {
        "rainbow.gif": 36, "rainbow_bias.gif": 7, "rainbow_rotation.gif": 36,
        "rainbow_elevation.gif": 3, "rainbow_distance.gif": 6}
    assert pframes["rainbow.gif"][0].shape == (8 * 32, 8 * 32, 3)


def thuman_tree(root, n=2, size=(200, 200)):
    """``root/<scan>/{depth_F,render,normal_F}/0.png``: the mask as the
    depth render's alpha, random RGB and normals."""
    rs = np.random.RandomState(3)
    h, w = size
    for i in range(n):
        for sub in ("depth_F", "render", "normal_F"):
            os.makedirs(os.path.join(root, f"scan{i}", sub))
        alpha = np.zeros((h, w), np.uint8)
        alpha[20 + 5 * i:h - 30, 80:170 - 4 * i] = 255
        depth = np.concatenate([(rs.rand(h, w, 3) * 255).astype(np.uint8), alpha[..., None]], -1)
        Image.fromarray(depth, "RGBA").save(os.path.join(root, f"scan{i}", "depth_F", "0.png"))
        for sub in ("render", "normal_F"):
            Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
                os.path.join(root, f"scan{i}", sub, "0.png"))
    return str(root)


def keypoint_files(root, tree):
    """CUB_200_2011's ``images.txt`` and ``parts/part_locs.txt`` for the test
    photos of ``tree``: 15 parts each, at random places, some not visible."""
    rs = np.random.RandomState(4)
    names = sorted(f for f in os.listdir(os.path.join(tree, "test", "c0")) if f.endswith(".jpg"))
    os.makedirs(os.path.join(root, "parts"))
    with open(os.path.join(root, "images.txt"), "w") as fp:
        fp.writelines(f"{i + 1} c0/{name}\n" for i, name in enumerate(names))
    with open(os.path.join(root, "parts", "part_locs.txt"), "w") as fp:
        for i, name in enumerate(names):
            h, w = np.asarray(Image.open(os.path.join(tree, "test", "c0", name))).shape[:2]
            for part in range(15):
                x, y, vis = rs.uniform(0, w), rs.uniform(0, h), int(rs.rand() < 0.8)
                fp.write(f"{i + 1} {part + 1} {x:.1f} {y:.1f} {vis}\n")
    return str(root)


def test_test_cub30_test_thu_and_test_pck(runs, jax_fast, tmp_path, monkeypatch):
    tree, jroot, proot = runs
    launches = dict(kernels.LAUNCHES)
    argv = ["--name", NAME, "--dataroot", tree]

    # test_cub30: the photos and the renders of the 12 bins, FID stubbed
    jsaved, psaved = [], []
    real = jcub30.save_images_parallel
    monkeypatch.setattr(jcub30, "save_images_parallel",
                        lambda pairs, workers=4: jsaved.extend(pairs) or real(pairs, workers))
    monkeypatch.setattr(pcub30, "save_images_parallel",
                        lambda pairs, workers=4: psaved.extend(pairs))
    monkeypatch.setattr(jcub30, "calculate_fid_given_paths", lambda paths, bs: 5.0)
    monkeypatch.setattr(pcub30, "fids_against", lambda ref, dirs, *a, **k: [5.0] * len(dirs))
    _in(jroot, monkeypatch, jcub30.main, argv)
    out = _in(proot, monkeypatch, pcub30.main, argv, device="cpu")
    assert out["fid"] == [5.0] * 12 and out["mean_fid"] == 5.0
    ref = {os.path.relpath(p, "log"): np.asarray(a) for a, p in jsaved}
    ours = {os.path.relpath(p, "log"): np.asarray(a) for a, p in psaved}
    assert sorted(ref) == sorted(ours) and len(ours) == 13 * 2  # two photos, each twice
    assert {p.split(os.sep)[2] for p in ours} == {"ori"} | {"azi%+04d" % a for a in pcub30.BINS}
    for path, a in ref.items():
        if path.split(os.sep)[2] == "ori":
            assert np.abs(ours[path] - a).max() <= 1.0 / 255 + 1e-6, path
        else:
            _check_rgb(a[None], ours[path][None])
    lines = [open(os.path.join(r, "log", NAME, "result.txt")).read().splitlines()[-1]
             for r in (jroot, proot)]
    assert lines[0] == lines[1] == "CUB30 mean FID: 5.00"

    # test_thu: the dataset's items and the normal MSE
    thu = thuman_tree(tmp_path / "thu")
    jitems, pitems = (cls(thu, 32, train=False, ratio=1.0) for cls in (JTHuman2Dataset,
                                                                          THuman2Dataset))
    assert len(jitems) == len(pitems) == 2
    for i in range(2):
        a, b = jitems[i], pitems[i]
        assert a["path"] == b["path"] and a["images"].shape == (32, 32, 4)
        assert np.array_equal(a["images"], b["images"]) and np.array_equal(a["normal"],
                                                                           b["normal"])
    mse = {}
    monkeypatch.setattr(jthu, "normal_mse", _recording(jthu.normal_mse, mse, "jax"))
    _in(jroot, monkeypatch, jthu.main, ["--name", NAME, "--dataroot", thu])
    out = _in(proot, monkeypatch, pthu.main, ["--name", NAME, "--dataroot", thu], device="cpu")
    assert out["batches"] == 1 and len(mse["jax"]) == 1
    assert abs(out["mse"] - mse["jax"][0]) <= 1e-5, (out["mse"], mse["jax"])

    # test_pck: PCK at 0.1 and 0.15 over a tiny keypoint file
    cub_root = keypoint_files(tmp_path / "CUB_200_2011", tree)
    argv = ["--name", NAME, "--dataroot", tree, "--cub_root", cub_root]
    _in(jroot, monkeypatch, jpck.main, argv)
    out = _in(proot, monkeypatch, ppck.main, argv, device="cpu")
    assert out["pairs"] == 2
    lines = [open(os.path.join(r, "log", NAME, "result.txt")).read().splitlines()[-2:]
             for r in (jroot, proot)]
    assert lines[0] == lines[1] and lines[1][0].startswith("PCK@0.1: ")
    assert kernels.LAUNCHES == launches  # CPU tensors never reach a kernel


def _recording(fn, store, key):
    def record(*args, **kwargs):
        value = fn(*args, **kwargs)
        store.setdefault(key, []).append(float(value))
        return value

    return record
