"""Checkpoints of the JAX package into the port: a restored
``magicmirror/train/checkpoints.py`` payload ``{"state": TrainState,
"epoch"}`` -> the port's ``{"state": TrainState.state_dict(), "epoch"}``,
which ``train/checkpoints.py::CheckpointManager.restore`` loads as it is.

    python -m magicmirror_torch.train.convert_jax --npz FILE --name NAME [--ckpt best_ckpt]

reads the run's options from ``./log/NAME/opts.yaml`` (the JAX run writes
them there) and writes ``./log/NAME/ckpts/<ckpt>``; a ``best_mesh.obj``
beside it is read by the eval CLIs as it is.  ``FILE`` is the payload as an
``.npz`` whose keys are the ``/``-joined tree paths (``state/params_e/...``,
``state/opt_state_e/0/mu``, ``epoch``): the orbax -> npz step needs jax and
orbax, so it runs on a host that has them (``tests/torch_parity.py::
export_jax_checkpoint``).

What is converted:
  * ``params_e`` / ``stats_e`` -> ``netE``, ``params_d`` -> ``netD``,
    ``swa_params`` / ``swa_stats`` -> ``swa_netE``, through
    ``models/convert.py`` (HWIO -> OIHW, dense transposed);
  * ``template``, ``em_step``, ``swa_n``, ``epoch`` and ``step``;
  * the critic, whichever of the three the run trains (``Discriminator``,
    ``MSDiscriminator`` of ``--gan_type lsgan``, ``SNDiscriminator`` of
    ``--sn_dis``);
  * the optimizers.  The JAX package runs ``flatten_groupscale``
    (``magicmirror/train/optim.py:47-91``, ``flat=True``) over optax
    ``amsgrad`` (the default), over ``adamw`` for the encoder under
    ``--adamw`` without ``--amsgrad``, and over a chain of a weight decay
    (or the identity) and ``adam`` otherwise (the critic of such a run):
    their states are ``(ScaleByAmsgradState(count, mu, nu, nu_max),
    EmptyState())``, ``(ScaleByAdamState(count, mu, nu), EmptyState(),
    EmptyState())`` and ``(EmptyState(), (ScaleByAdamState(count, mu, nu),
    EmptyState()))``, with ``mu``, ``nu`` (and ``nu_max``) each ONE raveled
    vector over the parameter leaves in ``jax.tree_util`` order (keys
    sorted at every level).  They are unravelled by the leaf shapes, laid
    out as the weights, and become ``train/optim.py::Amsgrad``'s
    per-parameter state, with ``count`` as every group's step count.  The
    layout expected is the port optimizer's (AMSGrad, decoupled or not); any
    other (a weight decay chained before amsgrad, ``flat=False``) raises and
    names it.

numpy and torch only.
"""
from __future__ import annotations

import argparse
import os
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from ..models.convert import flax_to_state_dict, load_flax_variables

AMSGRAD_FIELDS = ("count", "mu", "nu", "nu_max")
ADAM_FIELDS = ("count", "mu", "nu")
# optimizer -> (the tuple indices down to its moments' state, the size of
# each tuple on the way, the state's fields, the layout in words)
LAYOUTS = {
    "amsgrad": ((0,), (2,), AMSGRAD_FIELDS,
                "(ScaleByAmsgradState(count, mu, nu, nu_max), EmptyState())"),
    "adamw": ((0,), (3,), ADAM_FIELDS,
              "(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())"),
    "adam": ((1, 0), (2, 2), ADAM_FIELDS,
             "(EmptyState(), (ScaleByAdamState(count, mu, nu), EmptyState()))"),
}


def unflatten_npz(arrays: Mapping) -> dict:
    """{"a/b/c": array} -> nested dicts {"a": {"b": {"c": array}}}; a 0-d
    array becomes its Python scalar."""
    tree: dict = {}
    for key, value in arrays.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        value = np.asarray(value)
        node[leaf] = value.item() if value.ndim == 0 else value
    return tree


def _elements(node) -> dict | None:
    """A tuple node of the tree as {index: element}: a sequence, or a mapping
    keyed "0", "1", ... (a tuple out of an npz, whose empty elements are
    gone); None for another node."""
    if isinstance(node, Mapping):
        if node and all(str(k).isdigit() for k in node):
            return {int(k): v for k, v in node.items()}
        return None
    if isinstance(node, Sequence) and not isinstance(node, (str, bytes)):
        return dict(enumerate(node))
    return None


def _empty(node) -> bool:
    return node is None or (isinstance(node, (Mapping, Sequence)) and len(node) == 0)


def _leaves(tree: Mapping, prefix: tuple = ()):
    """(path, array) of a Flax tree in ``jax.tree_util`` order: the keys of
    every mapping sorted."""
    for key in sorted(tree, key=str):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def amsgrad_state(opt_state, what: str, layout: str = "amsgrad") -> dict:
    """The moments' fields of a ``flatten_groupscale`` state of ``layout``
    (``LAYOUTS``: optax amsgrad, adamw, or adam after a chained decay) ->
    {count, mu, nu[, nu_max]}; another layout raises ``ValueError`` naming
    it."""
    path, sizes, fields, words = LAYOUTS[layout]
    expected = (f"the port converts flatten_groupscale (flat=True) over optax {layout}: "
                f"{words}")
    node = opt_state
    for index, size in zip(path, sizes):
        parts = _elements(node)
        if (parts is None or index not in parts or not set(parts) <= set(range(size))
                or not all(_empty(v) for k, v in parts.items() if k != index)):
            raise ValueError(f"{what}: unsupported optimizer state layout "
                             f"{_describe(opt_state)}; {expected}")
        node = parts[index]
    if hasattr(node, "_asdict"):
        node = node._asdict()  # the namedtuple itself
    if not isinstance(node, Mapping) or set(node) != set(fields):
        raise ValueError(f"{what}: unsupported optimizer state layout "
                         f"{_describe(opt_state)} (a chained weight decay, another "
                         f"optimizer or flat=False); {expected}")
    out = {k: np.asarray(node[k]) for k in fields}
    if any(out[k].ndim != 1 for k in fields[1:]):
        raise ValueError(f"{what}: the moments are not raveled vectors (flat=False?); "
                         f"{expected}")
    return out


def _describe(node, depth: int = 0) -> str:
    """A short picture of a tree node's structure for an error message."""
    if isinstance(node, Mapping):
        if depth > 2:
            return "{...}"
        return "{" + ", ".join(f"{k}: {_describe(v, depth + 1)}"
                               for k, v in list(node.items())[:6]) + "}"
    if isinstance(node, Sequence) and not isinstance(node, (str, bytes)):
        return "(" + ", ".join(_describe(v, depth + 1) for v in node) + ")"
    if node is None:
        return "None"
    return f"array{tuple(np.shape(node))}"


def _as_torch(path: tuple, a: np.ndarray) -> tuple[str, np.ndarray]:
    """A Flax leaf at ``path`` -> (its torch key, the array in the torch
    layout), as ``flax_to_state_dict`` maps it."""
    tree = a
    for part in reversed(path):
        tree = {part: tree}
    (key, value), = flax_to_state_dict(tree).items()
    return key, value


def unravel_amsgrad(params: Mapping, opt_state, what: str,
                    layout: str = "amsgrad") -> tuple[int, dict]:
    """-> (count, {torch key: {"mu", "nu", "nu_max"} in the torch layout}):
    the raveled vectors cut by the leaf sizes of ``params`` in
    ``jax.tree_util`` order; Adam's states have no running maximum, and
    ``nu_max`` is zero."""
    st = amsgrad_state(opt_state, what, layout)
    st.setdefault("nu_max", np.zeros_like(st["nu"]))
    leaves = list(_leaves(params))
    total = sum(a.size for _, a in leaves)
    if st["mu"].shape[0] != total:
        raise ValueError(f"{what}: the raveled state has {st['mu'].shape[0]} elements, the "
                         f"parameters {total}")
    out, offset = {}, 0
    for path, a in leaves:
        cut = slice(offset, offset + a.size)
        offset += a.size
        moments = {k: _as_torch(path, st[k][cut].reshape(a.shape)) for k in
                   ("mu", "nu", "nu_max")}
        out[moments["mu"][0]] = {k: v for k, (_, v) in moments.items()}
    return int(st["count"]), out


def optimizer_layout(optimizer) -> str:
    """The ``LAYOUTS`` entry of the JAX optimizer the port's ``optimizer``
    (an ``Amsgrad``) stands for."""
    group = optimizer.param_groups[0]
    if group["amsgrad"]:
        return "amsgrad"
    return "adamw" if group.get("decoupled") else "adam"


def load_amsgrad(optimizer, module: torch.nn.Module, params: Mapping, opt_state,
                 what: str) -> None:
    """Fill ``optimizer`` (an ``Amsgrad`` over ``module``'s parameters) from
    the JAX optimizer state of ``params``, of the layout its own rule
    implies (:func:`optimizer_layout`): every parameter's moments, and
    ``count`` as every group's step count."""
    count, moments = unravel_amsgrad(params, opt_state, what, optimizer_layout(optimizer))
    names = {p: n for n, p in module.named_parameters()}
    for group in optimizer.param_groups:
        group["count"] = count
        for p in group["params"]:
            m = moments.pop(names[p])
            optimizer.state[p] = {k: torch.as_tensor(np.ascontiguousarray(v), dtype=p.dtype,
                                                     device=p.device) for k, v in m.items()}
    if moments:
        raise ValueError(f"{what}: moments of leaves the module does not have: "
                         f"{sorted(moments)[:5]}")


def load_jax_payload(state, payload: Mapping) -> int:
    """Fill the port's ``TrainState`` ``state`` in place from a JAX
    ``{"state": ..., "epoch"}`` payload (nested mappings of arrays) -> the
    payload's epoch."""
    s = payload["state"]
    load_flax_variables(state.netE, s["params_e"], s["stats_e"])
    load_flax_variables(state.netD, s["params_d"])
    load_flax_variables(state.swa_netE, s["swa_params"], s["swa_stats"])
    load_amsgrad(state.opt_e, state.netE, s["params_e"], s["opt_state_e"], "opt_state_e")
    load_amsgrad(state.opt_d, state.netD, s["params_d"], s["opt_state_d"], "opt_state_d")
    state.template = torch.as_tensor(np.asarray(s["template"], np.float32),
                                     device=state.template.device)
    state.em_step = float(np.float32(s["em_step"]))
    state.swa_n = int(s["swa_n"])
    state.epoch = int(s["epoch"])
    state.step = int(s["step"])
    return int(payload["epoch"])


def _build_state(opt):
    from . import build_trainer

    return build_trainer(opt, device="cpu").state


def convert(payload: Mapping, opt) -> dict:
    """A JAX payload -> the port's checkpoint payload ``{"state":
    TrainState.state_dict(), "epoch"}`` for the run's ``TrainOptions``
    ``opt`` (the modules are built on the CPU)."""
    state = _build_state(opt)
    epoch = load_jax_payload(state, payload)
    return {"state": state.state_dict(), "epoch": epoch}


def main(argv=None) -> str:
    """Convert ``--npz`` into ``./log/<name>/ckpts/<ckpt>`` -> its path."""
    from ..configs.flags import build_parser, load_options
    from . import train_options
    from .checkpoints import CheckpointManager

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--npz", required=True, help="the JAX payload, /-joined tree keys")
    parser.add_argument("--name", required=True, help="the run: ./log/<name>/opts.yaml")
    parser.add_argument("--ckpt", default="best_ckpt", help="the checkpoint's name")
    args = parser.parse_args(argv)
    opt = train_options(load_options(build_parser().parse_args(["--name", args.name]),
                                     skip=("name",)))
    ckpt = CheckpointManager(os.path.join("log", args.name, "ckpts"))
    if os.path.isdir(ckpt.path(args.ckpt)):
        raise FileExistsError(f"{ckpt.path(args.ckpt)} is a directory (the JAX package's "
                              "orbax checkpoint?); convert into another --name or --ckpt")
    with np.load(args.npz) as z:
        payload = unflatten_npz({k: z[k] for k in z.files})
    state = _build_state(opt)
    ckpt.save(args.ckpt, state, load_jax_payload(state, payload))
    print("wrote", ckpt.path(args.ckpt))
    return ckpt.path(args.ckpt)


if __name__ == "__main__":
    main()
