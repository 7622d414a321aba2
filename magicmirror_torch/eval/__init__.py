"""Evaluation: metrics, image and GIF artifacts, run reports and FID, the
port of ``magicmirror/eval``."""
