"""Encoders, backbones and building blocks (NCHW inside, NHWC at the
encoders' public inputs)."""
