"""What the kernel timing module computes without a card: the work it
bounds each kernel by, the L2-sized copies it times cold, and its loading of
another checkout of the port (``magicmirror_torch/benchmarks``).  The times
themselves come only from the card (tests/test_torch_kernels.py holds that a
CUDA-graph capture leaves the launch counts alone:
test_device_timing_moves_no_launch_count)."""
import os
import shutil
import subprocess
import sys

import torch

from magicmirror_torch.benchmarks import kernel_times, timing
from magicmirror_torch.ops.face_rows import face_rows
from magicmirror_torch.ops.rasterize import _tile_overlaps
from magicmirror_torch.render.renderer import DiffRender
from magicmirror_torch.render.synthetic import bench_attributes, to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_live_pairs_count_the_kernels_cull():
    """live_pairs against the plain path's statement of the kernels' cull
    (``_tile_overlaps``, per pixel row and column), front faces only, on a
    render whose size is no multiple of the tile."""
    size, batch = 40, 2
    dr = DiffRender(os.path.join(REPO, "template", "sphere.obj"), size, device="cpu")
    att = to_torch(bench_attributes(dr.vertices_init.numpy(), batch, size, 3), "cpu")
    fvc, fvi, fn = dr.project(att)
    rows = face_rows(fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn)
    in_x, in_y = _tile_overlaps(fvi, size, size)
    front = fn[..., 2] > 0
    per_tile = torch.zeros(batch, 3, 3)
    for ty in range(3):
        for tx in range(3):
            live = in_y[:, ty * 16] & in_x[:, tx * 16] & front
            per_tile[:, ty, tx] = live.sum(-1)
    ours = kernel_times.live_pairs(rows[:, :-1], size, size, per_tile=True)
    assert torch.equal(ours, per_tile) and per_tile.sum() > 0
    # the sentinel row faces away, and a zero cotangent switches a tile off
    assert kernel_times.live_pairs(rows, size, size) == int(per_tile.sum()) * 256
    g = torch.zeros(batch, size, size)
    g[0, :16, :16] = 1.0
    assert kernel_times.live_pairs(rows, size, size, g) == int(per_tile[0, 0, 0]) * 256


def test_bounds_and_cold_copies():
    assert timing.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert timing.bound_ms(0, 67e9) == (1.0, "operations")
    nbytes, pairs = kernel_times.raster_work(torch.zeros(2, 11, 26), 32, 32)
    assert nbytes == (2 * 11 * 26 + 2 * 11 * 4) * 4 + 2 * 32 * 32 * 32 and pairs == 0
    assert kernel_times.work_bound("raster_bwd", 0, 10**9) == (46e9 / 67e12 * 1e3,
                                                               "operations")
    assert timing.cold_copies(timing.L2_BYTES) == 3
    assert timing.cold_copies(1) == 100 and timing.cold_copies(10 * timing.L2_BYTES) == 1
    x = torch.arange(4.0)
    sets = timing.clone_inputs((x, 7), 3)
    assert len(sets) == 3 and sets[0][0] is x and sets[2][1] == 7
    assert torch.equal(sets[2][0], x) and sets[2][0].data_ptr() != x.data_ptr()


def test_load_port_takes_another_checkout(tmp_path):
    """``--tree``: the port's modules come from the other checkout, whose
    kernels build into its own ``build/``; the timing code stays this one's.
    In a process of its own: the other checkout replaces this one's package
    in ``sys.modules``."""
    tree = tmp_path / "other"
    shutil.copytree(os.path.join(REPO, "magicmirror_torch"), tree / "magicmirror_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\n"
            "from magicmirror_torch.benchmarks import kernel_times\n"
            f"port = kernel_times.load_port({str(tree)!r})\n"
            "from magicmirror_torch.kernels import build\n"
            "print(port.raster.__file__)\n"
            "print(port.kernels.LAUNCHES is sys.modules['magicmirror_torch.kernels'].LAUNCHES)\n"
            "print(build.BUILD_ROOT)\n"
            "print(kernel_times.__file__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": REPO}, check=True)
    raster, same, build_root, own = out.stdout.split()
    assert raster == str(tree / "magicmirror_torch" / "ops" / "rasterize.py")
    assert same == "True"
    assert build_root == str(tree / "build" / "magicmirror_torch")
    assert own == os.path.join(REPO, "magicmirror_torch", "benchmarks", "kernel_times.py")
