"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``).

Each kernel has a wrapper beside its plain PyTorch version:

  * ``raster_fwd`` (``csrc/raster_fwd.cu``) behind
    ``ops.rasterize.rasterize_fused``; it replaces the TPU kernel
    ``magicmirror/ops/pallas/rasterize_v4.py::_fwd_stream_kernel``; its
    plain mode (idx and sumlog only) behind ``ops.rasterize.rasterize_plain``
    replaces ``rasterize_v4.py::_fwd_kernel`` and counts as ``raster_fwd``;
  * ``texture_fwd`` (``csrc/texture_fwd.cu``) behind
    ``ops.sampling.texture_render``; it replaces
    ``magicmirror/ops/pallas/texture_cells.py::_tex_kernel``;
  * ``raster_bwd`` (``csrc/raster_bwd.cu``) behind the backward of
    ``ops.rasterize.RasterizeFused`` and ``RasterizePlain``; it replaces
    ``rasterize_v4.py::_bwd_stream_kernel`` and ``_bwd_kernel``;
  * ``texture_bwd`` (``csrc/texture_bwd.cu``) behind the backward of
    ``ops.sampling.TextureRender``; it replaces
    ``texture_cells.py::_tex_bwd_kernel``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, so a run
can show that its main path went through the kernels.  Nothing here builds or
loads at import; see ``build.py``.
"""
from __future__ import annotations

LAUNCHES = {"raster_fwd": 0, "texture_fwd": 0, "raster_bwd": 0, "texture_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
