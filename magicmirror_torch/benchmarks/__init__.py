"""Timing probes of the port's kernels, each the counterpart of a script of
``benchmarks/`` that times a TPU kernel."""
