"""The train state and its SWA and BatchNorm helpers, the port of
``magicmirror/train/state.py``.

``TrainState`` holds the two networks, their optimizers, the live template,
with ``inv > 0`` the shape gradient's preconditioner (built from the
template's Laplacian, which the EM update leaves as it is), the EM step size, the SWA average of the encoder (parameters and BatchNorm
buffers, a module of its own) with the count of models in it, the epoch and
the step count.  ``swa_update`` and ``update_bn`` are the counterparts of
``swa_update`` and ``make_update_bn``.
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from ..models.attribute_encoder import AttributeEncoder
from ..models.blocks import Dropout
from ..serve import _no_tf32
from .optim import Amsgrad


@dataclasses.dataclass
class TrainState:
    netE: AttributeEncoder
    netD: torch.nn.Module  # one of models/discriminators.py's critics
    opt_e: Amsgrad
    opt_d: Amsgrad
    template: torch.Tensor  # (V, 3) live template (vertices_init)
    step: int = 0
    em_step: float = 0.1  # decayed 0.99 per EM update
    swa_netE: AttributeEncoder | None = None  # the SWA average; a copy of netE when None
    swa_n: int = 0  # number of models averaged
    epoch: int = 0
    precond_M: torch.Tensor | None = None  # (V, V), with inv > 0

    def __post_init__(self):
        if self.swa_netE is None:
            self.swa_netE = copy.deepcopy(self.netE)

    def state_dict(self) -> dict:
        return {"netE": self.netE.state_dict(), "netD": self.netD.state_dict(),
                "opt_e": self.opt_e.state_dict(), "opt_d": self.opt_d.state_dict(),
                "template": self.template, "step": self.step, "em_step": self.em_step,
                "swa_netE": self.swa_netE.state_dict(), "swa_n": self.swa_n,
                "epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.netE.load_state_dict(state["netE"])
        self.netD.load_state_dict(state["netD"])
        self.opt_e.load_state_dict(state["opt_e"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.swa_netE.load_state_dict(state["swa_netE"])
        self.template = state["template"].to(self.template.device).clone()
        self.step = int(state["step"])
        self.em_step = float(state["em_step"])
        self.swa_n = int(state["swa_n"])
        self.epoch = int(state["epoch"])


@torch.no_grad()
def swa_update(state: TrainState) -> None:
    """Fold the encoder into its equal-weight running average, in place:
    avg + (p - avg) / (n + 1) over the parameters; the BatchNorm buffers are
    copied (``swa_update``, ``magicmirror/train/state.py:88-99``)."""
    avgs = list(state.swa_netE.parameters())
    diffs = torch._foreach_sub(list(state.netE.parameters()), avgs)
    torch._foreach_div_(diffs, float(state.swa_n) + 1.0)
    torch._foreach_add_(avgs, diffs)
    for avg, b in zip(state.swa_netE.buffers(), state.netE.buffers()):
        avg.copy_(b)
    state.swa_n += 1


@_no_tf32()
@torch.no_grad()
def update_bn(netE: AttributeEncoder, batches, template, lpl, generator,
              max_batches: int | None = None) -> None:
    """Move ``netE``'s BatchNorm running statistics over ``batches`` of
    images (B, H, W, 4), from the statistics it has: one momentum update per
    batch, with the BatchNorm and dropout layers in train mode (the dropout
    masks drawn from ``generator``), ``train_shape`` 0, no gradient, at most
    ``max_batches`` batches.  The counterpart of ``make_update_bn``
    (``magicmirror/train/state.py:101-126``).  ``serve.estimate_bn_stats``
    is another function: it resets the statistics and averages them."""
    drops = [m for m in netE.modules() if isinstance(m, Dropout)]
    generators = [m.generator for m in drops]
    was_training = netE.training
    netE.set_dropout_generator(generator)
    netE.train()
    try:
        for i, images in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            netE(images, template, lpl, train_shape=0)
    finally:
        for m, g in zip(drops, generators):
            m.generator = g
        netE.train(was_training)
