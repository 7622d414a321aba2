"""The trainer's state against the JAX package's at the tiny model
(``pretrains = pretraint = "none"``, 32^2, B = 2, numpy-drawn variables):
``swa_update`` on converted parameters and the EM encode sweep
(``encode_sweep`` against ``make_encode_sweep``, the trainer's ``white``
re-centring, the JAX function run op by op).

Tolerances: the SWA average within 1e-6 of each tensor's largest value
(float32, the same arithmetic); the encode sweep within 1e-4 (eval-mode
float32 encoders; tests/test_torch_slice.py holds the attributes to 1e-3).

Slow (the Flax encoder applied eagerly), and two test functions on purpose:
under ``pytest -n 6 --dist loadfile`` the files with the most tests are
handed out first, so a slow file with few tests runs beside the suite's long
files and not ahead of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.configs.flags import build_parser
from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror.train import em_update as jem
from magicmirror.train import trainer as jtrainer
from magicmirror.train.state import TrainState as JTrainState
from magicmirror.train.state import swa_update as jswa_update
from magicmirror_torch.models.convert import flax_to_state_dict, load_flax_variables
from magicmirror_torch.train import TrainOptions, build_trainer
from magicmirror_torch.train import em_update as tem
from magicmirror_torch.train.state import swa_update
from torch_parity import SPHERE, as_numpy_tree, flax_shapes, n, random_variables, t

torch.set_num_threads(1)
S, B = 32, 2


def _tiny(**changes):
    fields = dict(template_path=SPHERE, imageSize=S, batchSize=B, pretrains="none",
                  pretraint="none")
    return TrainOptions(**{**fields, **changes})


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny encoder with two numpy-drawn variable sets, and the
    port's trainer at the same configuration."""
    opt = build_parser().parse_args(["--imageSize", str(S), "--template_path", SPHERE,
                                     "--pretrains", "none", "--pretraint", "none"])
    jdr = JDiffRender(SPHERE, S, backend="xla")
    jnet, _ = jtrainer.build_models(opt, jdr)
    images = np.random.RandomState(0).rand(B, S, S, 4).astype(np.float32)
    shapes = flax_shapes(jnet, jnp.asarray(images), jdr.vertices_init,
                         jdr.vertices_laplacian_matrix, train=False)
    return opt, jdr, jnet, images, random_variables(shapes, 0), random_variables(shapes, 1)


def test_swa_update_matches_reference(tiny):
    _, jdr, _, _, live, avg = tiny
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    zero = jnp.asarray(0)
    state = JTrainState(params_e=as_jax(live["params"]), stats_e=as_jax(live["batch_stats"]),
                        params_d={}, opt_state_e=None, opt_state_d=None,
                        template=jdr.vertices_init, em_step=jnp.asarray(0.1),
                        swa_params=as_jax(avg["params"]), swa_stats=as_jax(avg["batch_stats"]),
                        swa_n=jnp.asarray(3), epoch=zero, step=zero)
    ref = jswa_update(state)
    want = flax_to_state_dict(as_numpy_tree(ref.swa_params), as_numpy_tree(ref.swa_stats))

    trainer = build_trainer(_tiny(), device="cpu")
    st = trainer.state
    load_flax_variables(st.netE, live["params"], live["batch_stats"])
    load_flax_variables(st.swa_netE, avg["params"], avg["batch_stats"])
    st.swa_n = 3
    swa_update(st)
    assert st.swa_n == int(ref.swa_n) == 4
    got = st.swa_netE.state_dict()
    for key, value in want.items():
        err = np.abs(n(got[key]) - value).max() / max(np.abs(value).max(), 1e-12)
        assert err <= 1e-6, (key, err)
    # the statistics are the live model's, copied
    live_sd = st.netE.state_dict()
    assert all(torch.equal(got[k], live_sd[k]) for k in got if "running" in k)


def test_encode_sweep_matches_reference(tiny):
    opt, jdr, jnet, images, live, _ = tiny
    lpl = jdr.vertices_laplacian_matrix
    trainer = build_trainer(_tiny(), device="cpu")
    netE, dr = trainer.state.netE, trainer.diff_render
    load_flax_variables(netE, live["params"], live["batch_stats"])
    netE.train()
    with jax.disable_jit():
        ref = jem.make_encode_sweep(jnet, jdr, lpl)(live["params"], live["batch_stats"],
                                                      jdr.vertices_init, jnp.asarray(images),
                                                      True)
    ours = tem.encode_sweep(netE, t(images), dr.vertices_init, dr.vertices_laplacian_matrix,
                            True)
    for a, b in zip(ours, ref):
        assert np.abs(n(a) - np.asarray(b)).max() <= 1e-4
    # re-centred per sample: white
    assert float(ours[0].mean(dim=1).abs().max()) <= 1e-5
    assert netE.training  # the sweep leaves the mode as it was
