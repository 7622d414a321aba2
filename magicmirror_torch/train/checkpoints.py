"""Checkpoints in the reference's layout, the port of
``magicmirror/train/checkpoints.py``: ``<outf>/ckpts/{latest_ckpt,best_ckpt}``,
each a ``torch.save`` file of ``{"state": TrainState.state_dict(), "epoch":
epoch}``, and ``best_mesh.obj`` beside them, the evolved template as every
eval script of the reference re-reads it."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry.obj_io import save_mesh


class CheckpointManager:
    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, name)

    def save(self, name: str, state, epoch: int) -> None:
        """Write ``state`` and ``epoch`` under ``ckpts/<name>`` (through a
        temporary file, so that a cut run leaves the last whole one)."""
        path = self.path(name)
        torch.save({"state": state.state_dict(), "epoch": int(epoch)}, path + ".tmp")
        os.replace(path + ".tmp", path)

    def restore(self, name: str, state):
        """Load ``ckpts/<name>`` into ``state`` in place -> {"state": state,
        "epoch": epoch}, or None when there is no such file."""
        path = self.path(name)
        if not os.path.exists(path):
            return None
        device = state.template.device
        payload = torch.load(path, map_location=device, weights_only=True)
        state.load_state_dict(payload["state"])
        return {"state": state, "epoch": int(payload["epoch"])}

    def save_best_mesh(self, template, faces, uvs) -> None:
        save_mesh(self.path("best_mesh.obj"), np.asarray(template), np.asarray(faces),
                  np.asarray(uvs))
