"""Market-SMPL's flat loss at full width, examined on the card (not a test:
run it by hand on a machine with an NVIDIA GPU; it imports no JAX).

    python3 tests/market_gap.py [STEPS]

The port alone, at the ``market_smpl`` configuration (``serve.PRESETS``:
``MARKET_DEFAULTS`` at imageSize 64, renders 128x64, ``smpl_uv.obj``, the
full-width encoders, 479,705,968 parameters) and three variants of it, each
STEPS (default 24) train steps at b32 as chip_smoke.py's train steps take
them: weights from seed 0, BatchNorm statistics of the first batch, four
batches of synthetic photos in turn (the template under bench.py's cameras
with the elevations mapped onto -15~15 and smooth random textures), lr
3e-4, warm-up min(1, 0.01 + i / 20), dropout on.
  * ``market_smpl``: as it is;
  * ``shape_frozen``: the same with the shape encoder frozen at every step
    (``train_shape=1``), so the 6,890-vertex shape head takes no update;
  * ``sphere2``: ``template/sphere2.obj`` in place of ``smpl_uv.obj`` (the
    proxy template of tests/loss_curves.py), the rest as it is;
  * ``default``: the default configuration (``sphere.obj``, 128^2), for
    the ratio.
Prints one JSON line a variant: lossR_data at every step, the mean of the
first four and of the last four, and the fall between them in percent,
with the card's name and power limit.
"""
import json
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from magicmirror_torch.benchmarks.timing import card  # noqa: E402
from magicmirror_torch.render.synthetic import (bench_attributes, smooth_random,  # noqa: E402
                                               to_torch)
from magicmirror_torch.serve import estimate_bn_stats  # noqa: E402
from magicmirror_torch.train import TrainOptions, build_trainer, preset_options  # noqa: E402

TEMPLATE = os.path.join(REPO, "template")
VARIANTS = {  # name -> (options, train_shape)
    "market_smpl": (dict(preset="market_smpl"), 0),
    "shape_frozen": (dict(preset="market_smpl"), 1),
    "sphere2": (dict(preset="market_smpl", template_path=os.path.join(TEMPLATE, "sphere2.obj")),
                0),
    "default": (dict(template_path=os.path.join(TEMPLATE, "sphere.obj")), 0),
}


def options(preset=None, **overrides):
    if preset is None:
        return TrainOptions(**overrides)
    overrides.setdefault("template_path", os.path.join(TEMPLATE, "smpl_uv.obj"))
    return preset_options(TrainOptions, preset, **overrides)


def photos(dr, batch, seed, elev_range):
    """chip_smoke.py's synthetic photos: the template under bench.py's
    cameras, elevations U(0, 30) mapped onto ``elev_range``."""
    att = bench_attributes(dr.vertices_init.cpu().numpy(), batch, dr.image_size, seed)
    lo, hi = (float(v) for v in elev_range.split("~"))
    att["elevations"] = (lo + (hi - lo) * att["elevations"] / 30.0).astype("float32")
    att["textures"] = smooth_random((batch, 2 * dr.render_height, dr.render_width, 3), seed)
    with torch.no_grad():
        return dr.render(**to_torch(att, dr.vertices_init.device))[0]


def run(name, steps):
    kwargs, train_shape = VARIANTS[name]
    opt = options(**dict(kwargs))
    trainer = build_trainer(opt)
    dr = trainer.diff_render
    batches = [photos(dr, 32, 10 + i, opt.elev_range) for i in range(4)]
    estimate_bn_stats(trainer.state.netE, batches[:1], dr.vertices_init,
                      dr.vertices_laplacian_matrix)
    t0 = time.perf_counter()
    data = [float(trainer.step(batches[i % 4], 3e-4, 3e-4, warm_up=min(1.0, 0.01 + i / 20.0),
                               train_shape=train_shape)[0]["lossR_data"])
            for i in range(steps)]
    first, last = statistics.mean(data[:4]), statistics.mean(data[-4:])
    print(json.dumps({"variant": name, "card": card(), "template": opt.template_path,
                      "shape": f"b32/{dr.render_height}x{dr.render_width}",
                      "train_shape": train_shape, "steps": steps,
                      "seconds": time.perf_counter() - t0, "lossR_data_first4": first,
                      "lossR_data_last4": last, "fall_percent": 100.0 * (first - last) / first,
                      "lossR_data": data}), flush=True)
    del trainer, batches
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        sys.exit("market_gap.py needs a CUDA device; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    for name in VARIANTS:
        run(name, steps)


if __name__ == "__main__":
    main()
