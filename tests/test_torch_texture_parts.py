"""K9c: the TPU probe of the masked texture kernel's body
(``benchmarks/bench_texcells_parts.py::make_kernel``) against the port's
``ops.sampling.texture_parts`` on the CPU (its plain version), levels 1, 4
and 5, at S = 32, B = 2.  The TPU kernel runs through ``pl.pallas_call(...,
interpret=True)`` with the script's own grid spec and chunk stream, on the
uv and coverage of the port's ``uv_sweep`` (dump_uv's sweep, its first
repetition) and the script's random texture, and its cell-major output is
laid back out as images.

Tolerances: below level 5 both write zeros, held exactly; at level 5 the
TPU kernel samples a bfloat16 texture with bfloat16 weights on the MXU, so
it is held to 8e-3 of the float32 sample (``tests/test_texture_cells.py``
holds the kernel to its dense path by the same 8e-3;
``tests/test_torch_texture_unmasked.py`` sees 4.4e-3 for the bfloat16
unmasked sampler; seen here 3.7e-3).
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from magicmirror.ops.pallas import texture_cells as tc
from magicmirror_torch.benchmarks.texture_parts import (random_texture, texels_touched,
                                                        texture_bytes, uv_sweep)
from magicmirror_torch.ops.sampling import texture_parts, texture_render_plain
from torch_parity import REPO, n

torch.set_num_threads(1)
S, B = 32, 2
LEVEL5_TOL = 8e-3


def _probe_module():
    path = os.path.join(REPO, "benchmarks", "bench_texcells_parts.py")
    spec = importlib.util.spec_from_file_location("bench_texcells_parts", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scene():
    uv, hard = uv_sweep(size=S, device="cpu", reps=1)
    uv, hard = uv[:B].contiguous(), hard[:B].contiguous()
    return uv, hard, random_texture(B, S, "cpu")


def _tpu_probe(level, uv, hard, tex):
    """bench_texcells_parts.main's preparation and call at this shape, in
    interpret mode -> (B, S, S, 3)."""
    probe = _probe_module()
    Ht, Wt = 2 * S, S
    ch, cw = tc.cell_shape(S, S)
    NC, npix, NBLK = (S // ch) * (S // cw), ch * cw, Ht // tc.BS
    uv, hard, tex = (jnp.asarray(n(x)) for x in (uv, hard, tex))
    y, x = tc._uv_to_texels(uv, Ht, Wt)
    m = hard > 0.5
    yc = tc._to_cells(jnp.where(m, y, tc._FAR_Y), ch, cw)
    xc = tc._to_cells(x, ch, cw)
    mc = tc._to_cells(m.astype(jnp.float32), ch, cw) > 0.5
    pk1, pk2, nlive, dropped = functools.partial(
        tc._build_chunks, Ht=Ht, Wt=Wt, tcap=tc.default_chunk_capacity(NC))(yc, xc, mc)
    assert int(np.asarray(dropped).sum()) == 0 and int(np.asarray(nlive).min()) > 0
    texT = jnp.transpose(tex, (0, 3, 1, 2)).reshape(B, 3 * Ht, Wt).astype(jnp.bfloat16)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3, grid=(B,),
        in_specs=[pl.BlockSpec((1, 3 * Ht, Wt), lambda b, *_: (b, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, NC, npix), lambda b, *_: (b, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, NC, npix), lambda b, *_: (b, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, NC + 1, 8, npix), lambda b, *_: (b, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((3, Wt, npix), jnp.float32)])
    cells = pl.pallas_call(
        probe.make_kernel(level, Ht, Wt, NC, npix, NBLK), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((B, NC + 1, 8, npix), jnp.float32),
        interpret=True)(pk1, pk2, nlive, texT, yc, xc)
    cells = jnp.transpose(cells[:, :NC, :3, :], (0, 1, 3, 2))
    return np.asarray(tc._from_cells(cells, S, S, ch, cw, 3))


@pytest.mark.parametrize("level", [1, 4, 5])
def test_probe_levels_match_the_tpu_probe(scene, level):
    uv, hard, tex = scene
    assert 0.05 < float(hard.mean()) < 0.95  # the sweep covers part of each image
    ref = _tpu_probe(level, uv, hard, tex)
    ours = n(texture_parts(uv, tex, hard, level))
    assert ours.shape == ref.shape == (B, S, S, 3)
    if level < 5:
        assert np.all(ours == 0.0) and np.all(ref == 0.0)
    else:
        np.testing.assert_array_equal(ours, n(texture_render_plain(uv, tex, hard)))
        assert np.abs(ours - ref).max() <= LEVEL5_TOL, np.abs(ours - ref).max()
        # both write exactly zero off the coverage
        off = n(hard) <= 0.5
        assert np.all(ours[off] == 0.0) and np.all(ref[off] == 0.0)


def test_unknown_level_raises(scene):
    uv, hard, tex = scene
    for level in (0, 2, 3, 6):
        with pytest.raises(ValueError, match="level"):
            texture_parts(uv, tex, hard, level)


@pytest.mark.parametrize("masked", [True, False])
def test_bound_counts_the_texels_the_taps_touch(scene, masked):
    """The bound's bytes: the distinct in-range texels under the four taps of
    the sampled pixels, counted one by one here in the sampler's float32
    arithmetic, exactly; the uv only where sampled."""
    uv, hard, tex = scene
    Ht, Wt = tex.shape[1], tex.shape[2]
    u, v = (np.clip(n(uv)[..., i], 0.0, 1.0) for i in (0, 1))
    x0 = np.floor(((u * np.float32(2) - np.float32(1) + np.float32(1)) * np.float32(Wt)
                   - np.float32(1)) * np.float32(0.5)).astype(int)
    y0 = np.floor(((-(v * np.float32(2) - np.float32(1)) + np.float32(1)) * np.float32(Ht)
                   - np.float32(1)) * np.float32(0.5)).astype(int)
    sampled = n(hard) > 0.5 if masked else np.ones(n(hard).shape, bool)
    texels = {(b, y, x)
              for b, i, j in zip(*np.nonzero(sampled))
              for y in (y0[b, i, j], y0[b, i, j] + 1) for x in (x0[b, i, j], x0[b, i, j] + 1)
              if 0 <= y < Ht and 0 <= x < Wt}
    mask = hard if masked else None
    assert texels_touched(uv, mask, tex) == len(texels) > 0
    P, covered = B * S * S, int(sampled.sum())
    assert texture_bytes(uv, mask, tex) == (4 * P if masked else 0) + 8 * covered \
        + 12 * len(texels) + 12 * P
    assert texture_bytes(uv, mask, tex, level=1) == (4 * P if masked else 0) + 12 * P
    assert texture_bytes(uv, mask, tex, backward=True) == (4 * P if masked else 0) \
        + 20 * covered + 12 * len(texels) + 8 * P + tex.numel() * 4
