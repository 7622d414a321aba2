"""The train state: the two networks, their optimizers, the live template
and the step count.  SWA, the EM step size and checkpoint files are not
ported yet."""
from __future__ import annotations

import dataclasses

import torch

from ..models.attribute_encoder import AttributeEncoder
from ..models.discriminators import Discriminator
from .optim import Amsgrad


@dataclasses.dataclass
class TrainState:
    netE: AttributeEncoder
    netD: Discriminator
    opt_e: Amsgrad
    opt_d: Amsgrad
    template: torch.Tensor  # (V, 3) live template (vertices_init)
    step: int = 0

    def state_dict(self) -> dict:
        return {"netE": self.netE.state_dict(), "netD": self.netD.state_dict(),
                "opt_e": self.opt_e.state_dict(), "opt_d": self.opt_d.state_dict(),
                "template": self.template, "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.netE.load_state_dict(state["netE"])
        self.netD.load_state_dict(state["netD"])
        self.opt_e.load_state_dict(state["opt_e"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.template = state["template"].to(self.template.device).clone()
        self.step = int(state["step"])
