"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``).

Four sources, each kernel with a wrapper beside its plain PyTorch version.
``LAUNCHES`` counts the launches under one name per TPU kernel (or family
of TPU kernels) of ``magicmirror/ops/pallas`` that the launch stands for:

  * ``csrc/raster_fwd.cu``, fused mode, behind ``ops.rasterize.rasterize_fused``:
    ``raster_fwd`` ('line' soft mode; ``rasterize_v4.py::_fwd_stream_kernel``),
    ``raster_fwd_dense`` (the same launch on a template of at least 2,048
    faces; ``rasterize_v6.py::_fwd6_kernel``), ``raster_exact_fused`` ('exact'
    soft mode; ``rasterize_tpu.py::_image_kernel_fused``);
  * the same source, plain mode (idx and sumlog only), behind
    ``ops.rasterize.rasterize_plain`` and ``dibr_rasterization``: counted as
    ``raster_fwd`` / ``raster_fwd_dense`` in 'line' mode
    (``rasterize_v4.py::_fwd_kernel``), ``raster_exact`` in 'exact' mode
    (``rasterize_tpu.py::_kernel``, ``_banded_kernel``, ``_image_kernel``:
    three schedules of one function);
  * ``csrc/raster_bwd.cu`` behind the backward of ``RasterizeFused`` and
    ``RasterizePlain`` in 'line' mode: ``raster_bwd``
    (``rasterize_v4.py::_bwd_stream_kernel``, ``_bwd_kernel``),
    ``raster_bwd_dense`` (``rasterize_v6.py::_bwd6_kernel``).  The 'exact'
    mode has no backward kernel, here as in the JAX package;
  * ``csrc/texture_fwd.cu`` and ``csrc/texture_bwd.cu`` behind
    ``ops.sampling.texture_render`` (masked: ``texture_fwd``, ``texture_bwd``;
    ``texture_cells.py::_tex_kernel``, ``_tex_bwd_kernel``) and behind
    ``ops.sampling.texture_mapping`` on CUDA tensors (unmasked:
    ``texture_unmasked_fwd``, ``texture_unmasked_bwd``;
    ``texture_tpu.py::_kernel``, whose backward the JAX package leaves to
    autodiff);
  * ``csrc/texture_fwd.cu``'s masked body cut short by level (1, 4 or 5)
    behind ``ops.sampling.texture_parts``: ``texture_parts``
    (``benchmarks/bench_texcells_parts.py::make_kernel``, the probe of K3's
    TPU body; run by ``magicmirror_torch/benchmarks/texture_parts.py``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each launch adds one to exactly one counter,
so a run can show that its main path went through the kernels.  Nothing here
builds or loads at import; see ``build.py``.
"""
from __future__ import annotations

LAUNCHES = dict.fromkeys(
    ("raster_fwd", "texture_fwd", "raster_bwd", "texture_bwd",
     "raster_fwd_dense", "raster_bwd_dense", "raster_exact", "raster_exact_fused",
     "texture_unmasked_fwd", "texture_unmasked_bwd", "texture_parts"), 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
