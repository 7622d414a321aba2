"""The BatchNorm refresh of the trainer: the port's ``train.state.update_bn``
against the JAX package's ``make_update_bn`` at the tiny model
(``pretrains = pretraint = "none"``, 32^2, dropout 0.2), over two batches,
from the same numpy-drawn variables (random running statistics included) and
with the same dropout masks: each mask is drawn here with numpy and handed to
both packages, in the order the layers run (the JAX side through a Flax
method interceptor, the port's through ``Dropout.mask``).  The JAX function
runs op by op (``jax.disable_jit``), so that the interceptor sees every call.

Batch 4, not 2: at 32^2 the texture decoder's deepest BatchNorm layers
normalise over batch x 1 x 1 samples, and with two samples a float32 rounding
difference grows to 0.1 of a running variance in either framework (seen with
these inputs at batch 2; ROADMAP section 3, "BatchNorm over a handful of
samples").  Tolerance: every running statistic within 1e-4 of its buffer's
largest value (float32 on both sides; seen 3.9e-6).  The second test shows
that ``serve.estimate_bn_stats`` (reset and average) is another function:
after one batch the least of its buffers' errors against ``make_update_bn``
is 0.40 of the buffer's largest value, while the port's ``update_bn`` meets
it within 3.1e-6.

Slow (the Flax encoder applied eagerly), and two test functions on purpose:
under ``pytest -n 6 --dist loadfile`` the files with the most tests are
handed out first, so a slow file with few tests runs beside the suite's long
files and not ahead of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

from magicmirror.configs.flags import build_parser
from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror.train.state import make_update_bn
from magicmirror.train.trainer import build_models as jbuild_models
from magicmirror_torch.models.blocks import Dropout
from magicmirror_torch.models.convert import flax_to_state_dict, load_flax_variables
from magicmirror_torch.render.renderer import DiffRender
from magicmirror_torch.serve import ServeOptions, build_models, estimate_bn_stats
from magicmirror_torch.train.state import update_bn
from torch_parity import SPHERE, as_numpy_tree, flax_shapes, random_variables, t

torch.set_num_threads(1)
S, B = 32, 4
TOL = 1e-4


def _setup(droprate):
    opt = build_parser().parse_args(["--imageSize", str(S), "--template_path", SPHERE,
                                     "--pretrains", "none", "--pretraint", "none",
                                     "--droprate", droprate])
    jdr = JDiffRender(SPHERE, S, backend="xla")
    jnet, _ = jbuild_models(opt, jdr)
    lpl = jdr.vertices_laplacian_matrix
    rs = np.random.RandomState(3)
    batches = [rs.rand(B, S, S, 4).astype(np.float32) for _ in range(2)]
    variables = random_variables(flax_shapes(jnet, jnp.asarray(batches[0]), jdr.vertices_init,
                                             lpl, train=False), seed=0)
    sopt = ServeOptions(template_path=SPHERE, imageSize=S, pretrains="none", pretraint="none",
                        droprate=droprate)
    dr = DiffRender(SPHERE, S, device="cpu")
    net = build_models(sopt, dr, "cpu")
    load_flax_variables(net, variables["params"], variables["batch_stats"])
    return jnet, jdr, lpl, variables, net, dr, batches


def _jax_update_bn(jnet, jdr, lpl, variables, batches, interceptor=None):
    fn = make_update_bn(jnet, lpl)
    loader = [{"images": b} for b in batches]
    with jax.disable_jit():
        if interceptor is None:
            stats = fn(variables["params"], variables["batch_stats"], jdr.vertices_init, loader,
                       jax.random.PRNGKey(0))
        else:
            with nn.intercept_methods(interceptor):
                stats = fn(variables["params"], variables["batch_stats"], jdr.vertices_init,
                           loader, jax.random.PRNGKey(0))
    return flax_to_state_dict(variables["params"], as_numpy_tree(stats))


def _max_rel_err(net, ref):
    errs = {}
    for key, value in net.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            r = ref[key]
            errs[key] = float(np.abs(value.numpy() - r).max() / max(np.abs(r).max(), 1e-12))
    return errs


def test_update_bn_matches_make_update_bn_with_the_same_dropout_masks():
    jnet, jdr, lpl, variables, net, dr, batches = _setup("0.2,0.2,0.2")
    rs = np.random.RandomState(7)
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        module = context.module
        if not isinstance(module, nn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        deterministic = kwargs.get("deterministic", args[1] if len(args) > 1 else None)
        if deterministic is None:
            deterministic = module.deterministic
        if deterministic or module.rate == 0.0:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = rs.rand(*x.shape) >= module.rate
        masks.append(keep)
        return jnp.where(keep, x / (1.0 - module.rate), 0.0)

    ref = _jax_update_bn(jnet, jdr, lpl, variables, batches, interceptor)
    # the port's dropout layers take the same masks, in the order they run;
    # a 4-D mask goes from NHWC to NCHW
    queue = list(masks)

    def take_mask(module, inputs):
        keep = torch.as_tensor(queue.pop(0))
        if keep.dim() == 4:
            keep = keep.permute(0, 3, 1, 2)
        assert keep.shape == inputs[0].shape
        module.mask = keep

    hooks = [m.register_forward_pre_hook(take_mask) for m in net.modules()
             if isinstance(m, Dropout) and m.rate > 0]
    update_bn(net, [t(b) for b in batches], dr.vertices_init, dr.vertices_laplacian_matrix,
              torch.Generator().manual_seed(0), max_batches=2)
    for h in hooks:
        h.remove()
    assert masks and not queue  # every mask drawn was taken, in order
    assert not net.training
    errs = _max_rel_err(net, ref)
    assert max(errs.values()) <= TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:5]


def test_estimate_bn_stats_is_not_make_update_bn():
    """One batch, dropout off: ``make_update_bn`` gives 0.9 old + 0.1 batch,
    as the port's ``update_bn`` does; ``estimate_bn_stats`` the batch alone."""
    jnet, jdr, lpl, variables, net, dr, batches = _setup("0,0,0")
    ref = _jax_update_bn(jnet, jdr, lpl, variables, batches[:1])
    state = {k: v.clone() for k, v in net.state_dict().items()}
    images = [t(batches[0])]
    update_bn(net, images, dr.vertices_init, dr.vertices_laplacian_matrix, None)
    assert max(_max_rel_err(net, ref).values()) <= TOL
    net.load_state_dict(state)
    estimate_bn_stats(net, images, dr.vertices_init, dr.vertices_laplacian_matrix)
    errs = _max_rel_err(net, ref)
    # the buffers move by far more than the tolerance: the old statistics
    # weigh 0.9 in the reference and nothing here
    assert min(errs.values()) > 100 * TOL, min(errs.values())
