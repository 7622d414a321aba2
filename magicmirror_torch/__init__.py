"""magicmirror_torch — the PyTorch + CUDA port of ``magicmirror`` for one
NVIDIA H100 (Hopper, sm_90a).

Module names mirror the JAX package so each module's counterpart is easy to
find.  Public tensors keep the JAX layouts: images NHWC in [0, 1] with the
mask as channel 3, textures (B, 2H, W, 3), and the attribute dict with the
reference's keys.  Inside the models, convolutions run NCHW.

The package imports torch and numpy only.  CUDA kernels (``csrc/``) are
built with nvcc on first use, never at import (``kernels/build.py``).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point builds on: the card unless the caller names
    another.  Raises when a CUDA device is asked for and there is none; the
    CPU is used only when asked for by name."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device
