"""The CLI flags and opts.yaml (``flags.py``)."""
