"""Attribute-cycle (interpolated-consistency) loss, the port of
``magicmirror/losses/attributes.py``."""
from __future__ import annotations

import math

import torch

from .chamfer import chamfer_distance


def angle2xy(angle_deg):
    """Degrees -> unit-circle embedding (B, 2)."""
    a = angle_deg * (math.pi / 180.0)
    return torch.stack([torch.cos(a), torch.sin(a)], dim=1)


def recon_att(pred_att, target_att, L1: bool = False, chamfer: bool = False,
              azim: float = 1.0):
    """Attribute reconstruction loss between two attribute dicts; returns
    (loss_cam, loss_shape, loss_texture, loss_light, loss_bias)."""
    if L1:
        def err(a, b):
            return (a - b).abs().mean()
    else:
        def err(a, b):
            return ((a - b) ** 2).mean()

    loss_azim = err(angle2xy(pred_att["azimuths"]), angle2xy(target_att["azimuths"]))
    loss_elev = err(angle2xy(pred_att["elevations"]), angle2xy(target_att["elevations"]))
    loss_dist = err(pred_att["distances"], target_att["distances"])
    loss_bias = err(pred_att["biases"], target_att["biases"])
    loss_cam = azim * loss_azim + loss_elev + loss_dist
    if chamfer:
        loss_shape, _ = chamfer_distance(pred_att["vertices"], target_att["vertices"])
    else:
        loss_shape = err(pred_att["vertices"], target_att["vertices"])
    loss_texture = err(pred_att["textures"], target_att["textures"])
    loss_light = 0.1 * err(pred_att["lights"], target_att["lights"])
    return loss_cam, loss_shape, loss_texture, loss_light, loss_bias
