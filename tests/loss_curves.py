"""lossR_data over N train steps of one configuration, the JAX package and the
port side by side on the CPU, from the same weights, photos and draws (not a
test: run it by hand).

    JAX_PLATFORMS=cpu python tests/loss_curves.py market 24 [THREADS]
    JAX_PLATFORMS=cpu python tests/loss_curves.py default 24 [THREADS]

THREADS (default 4) is torch's intra-op thread count: at 1 the port's CPU
run repeats bit for bit, at 4 its threaded reductions sum in an order that
varies from run to run.

The configurations are tests/test_torch_renderer_configs.py's at 64x32 /
32^2 with the tiny encoders and dropout off: ``market`` (``MARKET_DEFAULTS``
on ``sphere2.obj``) and ``default`` (``sphere.obj``).  Photos: the template
rendered by the port under bench.py's cameras (elevations mapped onto the
configuration's range) and smooth random textures, four batches of 4 in
turn, as chip_smoke.py's train steps take them; lr 3e-4, warm-up
min(1, 0.01 + i / 20).  Each step feeds both packages the draws of
``jax.random.PRNGKey(100 + i)``.  After the first step the two runs part
(Adam's first step is a sign, tests/test_torch_train_step.py), so the curves
are compared by their fall: the mean of the first four steps against the
last four.  Prints one JSON line a step and a summary line.
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import test_torch_renderer_configs as C  # noqa: E402
from magicmirror_torch.render.renderer import DiffRender  # noqa: E402
from magicmirror_torch.render.synthetic import (bench_attributes, smooth_random,  # noqa: E402
                                               to_torch)
from test_torch_train_step import _draws  # noqa: E402
from torch_parity import SPHERE, as_numpy_tree, flax_shapes, random_variables, t  # noqa: E402

C.CONFIGS["default"] = dict(template_path=SPHERE)


def photos(opt, seed):
    S, B = C.S, C.B
    dr = DiffRender(opt.template_path, S, ratio=opt.ratio, init_ellipsoid=opt.ellipsoid,
                    device="cpu")
    att = bench_attributes(dr.vertices_init.numpy(), B, S, seed, height=dr.render_height)
    lo, hi = (float(v) for v in opt.elev_range.split("~"))
    att["elevations"] = (lo + (hi - lo) * att["elevations"] / 30.0).astype("float32")
    att["textures"] = smooth_random((B, 2 * dr.render_height, dr.render_width, 3), seed)
    with torch.no_grad():
        return dr.render(**to_torch(att, "cpu"))[0].numpy()


def main(config, steps):
    opt, jdr, _ = C._renderers(config)
    batches = [photos(opt, 10 + i) for i in range(4)]
    netE = C.JAttributeEncoder(
        num_vertices=jdr.num_vertices, azi_scope=opt.azi_scope, elev_range=opt.elev_range,
        dist_range=opt.dist_range, nc=4, nk=opt.nk, nf=opt.nf, ratio=opt.ratio,
        pretraint=opt.pretraint, pretrainc=opt.pretrainc, pretrains=opt.pretrains,
        droprate=opt.droprate, norm=opt.norm)
    netD = C.JDiscriminator(nc=3, nf=16)
    lpl = jdr.vertices_laplacian_matrix
    ve = random_variables(flax_shapes(netE, jnp.asarray(batches[0]), jdr.vertices_init, lpl,
                                      train=False), seed=0)
    ve["params"]["shape_enc"]["linear3"]["kernel"] *= 0.02
    vd = random_variables(flax_shapes(netD, jnp.asarray(batches[0][..., :3])), seed=1)
    opt_e, opt_d = C.make_optimizer_e(), C.make_optimizer_d()
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    pe, se, pd = as_jax(ve["params"]), as_jax(ve["batch_stats"]), as_jax(vd["params"])
    state = C.JTrainState(
        params_e=pe, stats_e=se, params_d=pd, opt_state_e=opt_e.init(pe),
        opt_state_d=opt_d.init(pd), template=jdr.vertices_init, em_step=jnp.asarray(0.1),
        swa_params=pe, swa_stats=se, swa_n=jnp.asarray(0), epoch=jnp.asarray(0),
        step=jnp.asarray(0))
    step = C.make_train_step(opt, jdr, netE, netD, opt_e, opt_d, lpl, donate=False,
                             steps_per_call=1)
    topt = C.TrainOptions(imageSize=C.S, batchSize=C.B, pretrains="none", pretraint="none",
                          droprate="0,0,0", coordconv=False, image_weight=0.1,
                          **C.CONFIGS[config])
    trainer = C.build_trainer(topt, device="cpu")
    C.load_flax_variables(trainer.state.netE, ve["params"], ve["batch_stats"])
    C.load_flax_variables(trainer.state.netD, vd["params"])
    curves = {"jax": [], "torch": []}
    t0 = time.time()
    for i in range(steps):
        rng = jax.random.PRNGKey(100 + i)
        warm = min(1.0, 0.01 + i / 20.0)
        imgs = batches[i % 4]
        state, m, _, _ = step(state, jnp.asarray(imgs), rng, 3e-4, 3e-4, warm, 0)
        tm, _, _ = trainer.step(t(imgs), 3e-4, 3e-4, warm, 0, draws=_draws(opt, rng))
        curves["jax"].append(float(as_numpy_tree(m)["lossR_data"]))
        curves["torch"].append(float(tm["lossR_data"]))
        print(json.dumps({"config": config, "step": i, "jax": curves["jax"][-1],
                          "torch": curves["torch"][-1], "s": round(time.time() - t0)}),
              flush=True)

    def fall(v):
        return 100.0 * (np.mean(v[:4]) - np.mean(v[-4:])) / np.mean(v[:4])

    print(json.dumps({"config": config, "steps": steps,
                      **{f"{k}_first4": float(np.mean(v[:4])) for k, v in curves.items()},
                      **{f"{k}_last4": float(np.mean(v[-4:])) for k, v in curves.items()},
                      **{f"{k}_fall_percent": fall(v) for k, v in curves.items()},
                      **curves}))


if __name__ == "__main__":
    torch.set_num_threads(int(sys.argv[3]) if len(sys.argv) > 3 else 4)
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 24)
