"""magicmirror_torch — the PyTorch + CUDA port of ``magicmirror`` for one
NVIDIA H100 (Hopper, sm_90a).

Module names mirror the JAX package so each module's counterpart is easy to
find.  Public tensors keep the JAX layouts: images NHWC in [0, 1] with the
mask as channel 3, textures (B, 2H, W, 3), and the attribute dict with the
reference's keys.  Inside the models, convolutions run NCHW.

The package imports torch and numpy only.  CUDA kernels (``csrc/``) are
built with nvcc on first use, never at import (``kernels/build.py``).
"""
