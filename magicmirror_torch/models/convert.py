"""Weights into the port: Flax variables -> the port's state dict, and the
JAX package's init laws from a seed.

The port's modules carry the Flax names (``blocks.FlaxNamed``), so a Flax
path ``a/b/Conv_0/kernel`` is the torch key ``a.b.Conv_0.weight``.  Layouts:
conv HWIO -> OIHW, dense (in, out) -> (out, in), BatchNorm scale / bias /
mean / var -> weight / bias / running_mean / running_var; ``MMPool.p``,
``LayerNormAll``'s ``gamma`` / ``beta`` as they are; the affine InstanceNorm
of ``IBN`` (``IN``) as BatchNorm's parameters; ``SNConv``'s raw HWIO kernel
as any conv's.  The inverse of ``magicmirror/models/convert_torch.py``.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .blocks import BatchNorm, InstanceNorm, LayerNormAll, MMPool
from .discriminators import SNConv

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "p": "p",
                 "gamma": "gamma", "beta": "beta"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def flax_to_state_dict(params: Mapping, batch_stats: Mapping | None = None) -> dict:
    """Flax ``params`` / ``batch_stats`` trees (nested dicts of arrays) ->
    {torch key: numpy array in the torch layout}."""
    out = {}
    for tree, leaves in ((params, _PARAM_LEAVES), (batch_stats or {}, _STAT_LEAVES)):
        for path, a in _flatten(tree):
            if path[-1] not in leaves:
                raise ValueError(f"unknown Flax leaf {'/'.join(path)}")
            if path[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            out[".".join(path[:-1] + (leaves[path[-1]],))] = a
    return out


def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping | None = None) -> nn.Module:
    """Fill ``model`` from Flax variables, strictly: every Flax leaf must be
    consumed and every parameter and running statistic set (BatchNorm's
    ``num_batches_tracked`` counter has no Flax counterpart)."""
    arrays = flax_to_state_dict(params, batch_stats)
    target = model.state_dict()
    wanted = {k for k in target if not k.endswith("num_batches_tracked")}
    missing = sorted(wanted - arrays.keys())
    unexpected = sorted(arrays.keys() - wanted)
    if missing or unexpected:
        raise ValueError(f"Flax variables do not match the model: missing {missing}, "
                         f"unexpected {unexpected}")
    bad = [f"{k}: {arrays[k].shape} vs {tuple(target[k].shape)}"
           for k in sorted(arrays) if tuple(arrays[k].shape) != tuple(target[k].shape)]
    if bad:
        raise ValueError(f"shape mismatch: {bad}")
    with torch.no_grad():
        for key, a in arrays.items():
            target[key].copy_(torch.as_tensor(np.ascontiguousarray(a)))
    return model


def init_from_seed(model: nn.Module, seed: int) -> nn.Module:
    """The JAX package's init laws (``magicmirror/models/blocks.py``),
    drawn from a seeded ``torch.Generator``: conv and dense weights (and
    ``SNConv``'s raw kernel) kaiming-normal fan-in, classifier heads N(0,
    1e-5), biases 0, BatchNorm scale N(1, 0.02) (1 for the landmark head's
    Flax ``nn.BatchNorm``) with zero mean and unit variance, the affine
    InstanceNorm's scale N(1, 0.02), LayerNormAll's gamma U(0, 1) and beta
    0, MMPool mix 0.  The draws are made on the CPU, so the weights do not
    depend on the device."""
    g = torch.Generator().manual_seed(seed)

    def normal(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=g) * std + mean)

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear, SNConv)):
                fan_in = module.weight[0].numel()
                if getattr(module, "classifier", False):
                    normal(module.weight, 1e-5)
                else:
                    normal(module.weight, math.sqrt(2.0 / fan_in))
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                if getattr(module, "unit_scale", False):
                    module.weight.fill_(1.0)
                else:
                    normal(module.weight, 0.02, mean=1.0)
                module.bias.zero_()
                module.reset_running_stats()
            elif isinstance(module, InstanceNorm) and module.affine:
                normal(module.weight, 0.02, mean=1.0)
                module.bias.zero_()
            elif isinstance(module, LayerNormAll):
                module.gamma.copy_(torch.rand(module.gamma.shape, generator=g))
                module.beta.zero_()
            elif isinstance(module, MMPool):
                module.p.zero_()
    return model
