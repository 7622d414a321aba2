"""The port's ``template_animation`` against the JAX CLI's, on the CPU: a
run directory of 17 ``epoch_*_template.obj`` files (``sphere_dryrun.obj``
moved a little more each epoch), once without opts.yaml (the flags as
given, 32^2) and once with a run's opts.yaml (32 x 64, ratio 2) and
``--step 3``.  Both render in hard mode (sigmainv 1e6).

  * the GIF's frames: as many, each within 3 of 255 of the JAX CLI's
    (the renders' 1e-2 cap on rgb and the rounding to 8 bits; the frame is
    the rgb, whose coverage is the hard mask, not the near-step soft one);
  * the strip PNG: the same shape, the same frames side by side;
  * the GIF file holds the frames at 300 ms each; no kernel launch.

The JAX CLI's eager render runs jitted here (the same function, one XLA
program) and its imageio writers keep the frames (imageio is not on the
card's machine; the port writes through its own GIF and PNG writers).
"""
import os
import struct

import jax
import numpy as np
import pytest
import torch

import magicmirror.cli.template_animation as janim
import magicmirror_torch.cli.template_animation as panim
from magicmirror.configs.flags import build_parser, save_options
from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror_torch import kernels
from magicmirror_torch.eval.images import decode_png
from magicmirror_torch.geometry.obj_io import load_obj, save_mesh
from torch_parity import DRYRUN

torch.set_num_threads(1)
NAME = "anim"


class JitRender(JDiffRender):
    """The JAX renderer with ``render`` under ``jax.jit``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._jitted = jax.jit(lambda att: JDiffRender.render(self, **att))

    def render(self, **att):
        return self._jitted(att)


def template_run(root, n=17):
    """``root/log/<NAME>/epoch_<k>_template.obj`` for k < n, written as the
    trainer writes them (the template's uvs, vertex-only faces)."""
    mesh = load_obj(DRYRUN)
    outf = os.path.join(root, "log", NAME)
    os.makedirs(outf, exist_ok=True)
    rs = np.random.RandomState(2)
    v = 0.8 * mesh.vertices / np.abs(mesh.vertices).max()
    for k in range(n):
        v = v + 0.01 * rs.randn(*v.shape)
        save_mesh(os.path.join(outf, f"epoch_{k}_template.obj"), v, mesh.faces, mesh.uvs)
    return outf


def gif_delays(path):
    """The delay (in 1/100 s) of each frame of a GIF file."""
    data = open(path, "rb").read()
    return [struct.unpack("<H", data[i + 4:i + 6])[0]
            for i in range(len(data) - 6) if data[i:i + 3] == b"\x21\xf9\x04"]


@pytest.mark.parametrize("case", ["flags", "opts_yaml_step3"])
def test_template_animation_matches_the_jax_cli(case, tmp_path, monkeypatch):
    import imageio

    outf = template_run(tmp_path)
    argv = ["--name", NAME, "--imageSize", "32"]
    if case == "opts_yaml_step3":
        monkeypatch.chdir(tmp_path)
        opt = build_parser().parse_args(["--name", NAME, "--imageSize", "32", "--ratio", "2"])
        opt.outf = outf
        save_options(opt)
        argv += ["--step", "3"]
    ref, strip = [], {}

    class Writer:
        def append_data(self, frame):
            ref.append(np.asarray(frame))

        def close(self):
            pass

    monkeypatch.setattr(janim, "DiffRender", JitRender)
    monkeypatch.setattr(imageio, "get_writer", lambda path, mode="I", duration=None: Writer())
    monkeypatch.setattr(imageio, "imwrite", lambda path, a: strip.update(jax=np.asarray(a)))
    ours = []
    real = panim.write_gif
    monkeypatch.setattr(panim, "write_gif", lambda path, frames, **kw: (
        ours.extend(frames), real(path, frames, **kw)))
    monkeypatch.chdir(tmp_path)
    launches = dict(kernels.LAUNCHES)
    janim.main(argv)
    out = panim.main(argv, device="cpu")
    assert kernels.LAUNCHES == launches

    n = 17 if case == "flags" else 6
    H = 32 if case == "flags" else 64
    assert len(ref) == len(ours) == out["frames"] == n
    for a, b in zip(ref, ours):
        assert a.shape == b.shape == (H, 32, 3)
        assert (b < 250).mean() > 0.05  # the template is in view
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 3
    with open(os.path.join(tmp_path, out["png"]), "rb") as fp:
        png = decode_png(fp.read())
    step = max(1, n // 8)
    assert png.shape == strip["jax"].shape == (H, 32 * len(ours[::step]), 3)
    assert np.array_equal(png, np.concatenate(ours[::step], axis=1))
    assert gif_delays(os.path.join(tmp_path, out["gif"])) == [30] * n

