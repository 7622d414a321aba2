"""Rendering ops: rasterizer, texture sampling, SH shading."""
