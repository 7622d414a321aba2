"""Port parity of the loss suite (magicmirror_torch/losses vs
magicmirror/losses): value and gradient of every function on the same
numpy-drawn inputs.

Tolerance: 1e-5 relative to the value, and to the largest absolute gradient
(the same float32 formulas; seen 2e-6).  The gradient penalty shares the
critic's weights across the packages and takes its interpolation weights as
an argument; its gradient with respect to the critic's parameters is a double
backward through 15 convolutions, held to 1e-4 (seen 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.losses import attributes as jatt
from magicmirror.losses import chamfer as jchamfer
from magicmirror.losses import gan as jgan
from magicmirror.losses import mesh_reg as jreg
from magicmirror.losses import recon as jrecon
from magicmirror.models.discriminators import Discriminator as JDiscriminator
from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror_torch.losses import attributes, chamfer, gan, mesh_reg, recon
from magicmirror_torch.models.convert import load_flax_variables
from magicmirror_torch.models.discriminators import Discriminator
from magicmirror_torch.render.renderer import DiffRender
from torch_parity import SPHERE, flax_shapes, n, random_variables, t

torch.set_num_threads(1)
B, S = 2, 16
TOL = 1e-5


def _check(ours_fn, ref_fn, arrays, tol=TOL):
    """Value and gradients of ours_fn(*tensors) vs ref_fn(*jax arrays)."""
    tensors = [t(a).requires_grad_(True) for a in arrays]
    value = ours_fn(*tensors)
    value.backward()
    ref_value, ref_grads = jax.value_and_grad(ref_fn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    assert abs(float(value) - float(ref_value)) <= tol * max(abs(float(ref_value)), 1e-3)
    for x, g in zip(tensors, ref_grads):
        g = np.asarray(g)
        assert np.isfinite(n(x.grad)).all()
        assert np.abs(n(x.grad) - g).max() <= tol * max(np.abs(g).max(), 1e-6)


@pytest.fixture(scope="module")
def renders():
    return JDiffRender(SPHERE, S, backend="xla"), DiffRender(SPHERE, S, device="cpu")


@pytest.fixture
def rs():
    return np.random.RandomState(0)


def _rgba(rs):
    return rs.rand(B, S, S, 4).astype(np.float32)


def test_mask_iou_loss(rs):
    _check(recon.mask_iou_loss, jrecon.mask_iou_loss, [_rgba(rs)[..., 3], _rgba(rs)[..., 0]])


def test_contour_loss(rs):
    _check(recon.contour_loss, jrecon.contour_loss, [_rgba(rs)[..., 3], _rgba(rs)[..., 0]])


@pytest.mark.parametrize("contour", [0.0, 0.5])
def test_recon_data(rs, contour):
    _check(lambda p, g: recon.recon_data(p, g, image_weight=0.3, contour=contour),
           lambda p, g: jrecon.recon_data(p, g, image_weight=0.3, contour=contour),
           [_rgba(rs), _rgba(rs)])


def test_angle2xy(rs):
    a = rs.uniform(-180, 180, 5).astype(np.float32)
    np.testing.assert_allclose(n(attributes.angle2xy(t(a))), np.asarray(jatt.angle2xy(a)),
                               atol=1e-6)


def _att(rs, V=20):
    f32 = np.float32
    return [rs.uniform(-180, 180, B).astype(f32), rs.uniform(0, 30, B).astype(f32),
            rs.uniform(2, 7, B).astype(f32), rs.uniform(-1, 1, (B, 2)).astype(f32),
            rs.randn(B, V, 3).astype(f32), rs.rand(B, 8, 4, 3).astype(f32),
            rs.randn(B, 9).astype(f32)]


_KEYS = ("azimuths", "elevations", "distances", "biases", "vertices", "textures", "lights")


@pytest.mark.parametrize("L1,use_chamfer", [(False, True), (False, False), (True, True)])
def test_recon_att(rs, L1, use_chamfer):
    target = dict(zip(_KEYS, _att(rs)))

    def ours(*pred):
        tgt = {k: t(v) for k, v in target.items()}
        return sum(attributes.recon_att(dict(zip(_KEYS, pred)), tgt, L1=L1,
                                        chamfer=use_chamfer, azim=0.7))

    def ref(*pred):
        return sum(jatt.recon_att(dict(zip(_KEYS, pred)), target, L1=L1, chamfer=use_chamfer,
                                  azim=0.7))

    _check(ours, ref, _att(rs))


def test_chamfer_distance(rs):
    x, y = rs.randn(B, 30, 3).astype(np.float32), rs.randn(B, 25, 3).astype(np.float32)
    _check(lambda a, b: chamfer.chamfer_distance(a, b)[0],
           lambda a, b: jchamfer.chamfer_distance(a, b)[0], [x, y])


def _delta(rs, V):
    d = (0.1 * rs.randn(B, V, 3)).astype(np.float32)
    d[0, 3] = 0.0  # a zero row: _safe_norm's gradient there is 0, not NaN
    return d


def test_laplacian_flat_loss(rs, renders):
    jdr, dr = renders
    fn = rs.randn(B, jdr.num_faces, 3).astype(np.float32)
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
    _check(lambda d, f: mesh_reg.laplacian_flat_loss(d, f, dr.vertices_laplacian_matrix,
                                                     dr.edge2faces),
           lambda d, f: jreg.laplacian_flat_loss(d, f, jdr.vertices_laplacian_matrix,
                                                 jdr.edge2faces),
           [_delta(rs, jdr.num_vertices), fn])


def test_edge_loss(rs, renders):
    jdr, dr = renders
    v = np.asarray(jdr.vertices_init)[None] + _delta(rs, jdr.num_vertices)
    _check(lambda x: mesh_reg.edge_loss(x, dr.edges), lambda x: jreg.edge_loss(x, jdr.edges),
           [v])


def test_depth_losses(rs, renders):
    jdr, dr = renders
    v = np.asarray(jdr.vertices_init)[None] + _delta(rs, jdr.num_vertices)
    _check(mesh_reg.depth_loss, jreg.depth_loss, [v])
    _check(lambda x: mesh_reg.depth_loss_R(x, dr.sign_init, ratio=1.3, temp=1.5),
           lambda x: jreg.depth_loss_R(x, jdr.sign_init, ratio=1.3, temp=1.5), [v])
    _check(lambda x: mesh_reg.depth_loss_C(x, dr.sign_init, ratio=1.3),
           lambda x: jreg.depth_loss_C(x, jdr.sign_init, ratio=1.3), [v])


def test_deform_loss_has_a_finite_gradient_at_zero(rs):
    d = _delta(rs, 12)
    _check(mesh_reg.deform_loss, jreg.deform_loss, [d])
    zero = torch.zeros(1, 4, 3, requires_grad=True)
    mesh_reg.deform_loss(zero).backward()
    assert torch.isfinite(zero.grad).all() and not zero.grad.any()


@pytest.mark.parametrize("L1", [False, True])
def test_flip_loss(rs, renders, L1):
    jdr, dr = renders
    _check(lambda d: mesh_reg.flip_loss(d, dr.flip_index, dr.sign_init, L1=L1),
           lambda d: jreg.flip_loss(d, jdr.flip_index, jdr.sign_init, L1=L1),
           [_delta(rs, jdr.num_vertices)])


def test_diffrender_loss_methods_delegate(rs, renders):
    """The methods of DiffRender pass their own constants on."""
    jdr, dr = renders
    delta = _delta(rs, jdr.num_vertices)
    fn = rs.randn(B, jdr.num_faces, 3).astype(np.float32)
    verts = np.asarray(jdr.vertices_init)[None] + delta
    pairs = [
        (dr.recon_flip({"delta_vertices": t(delta)}),
         jdr.recon_flip({"delta_vertices": delta})),
        (dr.calc_reg_loss({"delta_vertices": t(delta), "face_normals": t(fn)}),
         jdr.calc_reg_loss({"delta_vertices": delta, "face_normals": fn})),
        (dr.calc_reg_edge(t(verts)), jdr.calc_reg_edge(verts)),
        (dr.calc_reg_depth(t(verts)), jdr.calc_reg_depth(verts)),
        (dr.calc_reg_depthR(t(verts)), jdr.calc_reg_depthR(verts)),
        (dr.calc_reg_depthC(t(verts)), jdr.calc_reg_depthC(verts)),
        (dr.calc_reg_deform(t(delta)), jdr.calc_reg_deform(delta)),
        (dr.recon_data(t(_rgba(np.random.RandomState(1))), t(_rgba(np.random.RandomState(2)))),
         jdr.recon_data(_rgba(np.random.RandomState(1)), _rgba(np.random.RandomState(2)))),
    ]
    for ours, ref in pairs:
        assert abs(float(ours) - float(ref)) <= TOL * max(abs(float(ref)), 1e-3)


def test_wgan_losses(rs):
    o = [rs.randn(B, 1).astype(np.float32) for _ in range(3)]
    _check(lambda a, b, c: gan.d_loss_wgan(a, b, c, 0.3, 1e-4, 0.7, 10.0)[0],
           lambda a, b, c: jgan.d_loss_wgan(a, b, c, 0.3, 1e-4, 0.7, 10.0)[0], o)
    _check(lambda a, b: gan.g_loss_wgan(a, b, 1e-4, 0.7),
           lambda a, b: jgan.g_loss_wgan(a, b, 1e-4, 0.7), o[:2])
    ours = gan.d_loss_wgan(*map(t, o), 0.3, 1e-4, 0.7, 10.0)
    ref = jgan.d_loss_wgan(*o, 0.3, 1e-4, 0.7, 10.0)
    np.testing.assert_allclose([float(v) for v in ours], [float(v) for v in ref], rtol=1e-6)


def test_gradient_penalty_with_shared_critic_and_injected_alpha(rs):
    jD = JDiscriminator(nc=3, nf=16)
    real, fake = rs.rand(B, 32, 32, 3).astype(np.float32), rs.rand(B, 32, 32, 3).astype(np.float32)
    variables = random_variables(flax_shapes(jD, jnp.asarray(real)), seed=2)
    D = load_flax_variables(Discriminator(nc=3, nf=16), variables["params"])
    key = jax.random.PRNGKey(5)
    alpha = jax.random.uniform(key, (B, 1, 1, 1), dtype=jnp.float32)

    def ref_fn(params):
        return jgan.gradient_penalty(lambda x: jD.apply({"params": params}, x), real, fake, key)

    ref, ref_grads = jax.value_and_grad(ref_fn)(variables["params"])
    gp = gan.gradient_penalty(D, t(real), t(fake), t(alpha))
    gp.backward()
    assert abs(float(gp) - float(ref)) <= 1e-5 * abs(float(ref))
    for i in range(15):
        g = np.asarray(ref_grads[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)
        ours = n(getattr(D, f"Conv_{i}").weight.grad)
        assert np.abs(ours - g).max() <= 1e-4 * np.abs(g).max(), i
