"""Timing a kernel on the card, and the card's published figures the bounds
are taken against.  Shared by ``texture_parts``, ``kernel_times`` and
``chip_smoke.py``; imports torch only, so that ``kernel_times`` can time the
wrappers of another checkout of the port with it.

* :func:`burst_ms`: one pair of CUDA events around a burst of launches from
  Python; the host's launch path sets its pace when a kernel is short.
* :func:`graph_ms`: the device alone, launches replayed from one CUDA graph.
* :func:`device_ms`: :func:`graph_ms` warm (one set of inputs, kept in the
  L2 from launch to launch) and cold (copies of the inputs taken in turn,
  whose reads are three times the L2, so each launch finds its inputs in
  device memory).
"""
from __future__ import annotations

import math
import subprocess

import torch

# the card's published figures (H100 SXM data sheet): device memory, fp32
# outside the tensor cores, and the L2 cache
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
L2_BYTES = 50 * 2**20


def card() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take for a launch that must move
    ``nbytes`` and do ``flops`` fp32 operations: the larger of the two over
    the card's rates -> (ms, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def burst_ms(fn, launches: int = 100, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn``: one pair of CUDA events around
    ``launches`` calls, divided by their number."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def graph_ms(fns, counters: dict, launches: int = 100, warmup: int = 3) -> float:
    """Milliseconds per call on the device alone: ``launches`` calls, taking
    ``fns`` in turn, captured in one CUDA graph; one replay between a pair of
    CUDA events, divided by their number.  A burst from Python
    (:func:`burst_ms`) queues kernels no faster than the host launches them;
    the replay has no host in between.  The warm-up and the capture launch
    nothing that a run should count, so ``counters`` (the port's
    ``kernels.LAUNCHES``) is put back as it was."""
    counts = dict(counters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            for fn in fns:
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fns[i % len(fns)]()
    counters.update(counts)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def cold_copies(read_bytes: int) -> int:
    """How many copies of a launch's inputs, taken in turn, make its reads
    three times the L2 (at most 100)."""
    return max(1, min(math.ceil(3 * L2_BYTES / max(read_bytes, 1)), 100))


def clone_inputs(inputs: tuple, copies: int) -> list:
    """``inputs`` and ``copies - 1`` clones of its tensors (anything else is
    passed on as it is)."""
    return [inputs] + [tuple(x.clone() if torch.is_tensor(x) else x for x in inputs)
                       for _ in range(copies - 1)]


def device_ms(fn, inputs: tuple, read_bytes: int, counters: dict, sets=None) -> dict:
    """``fn(*inputs)`` on the device alone: ``warm_ms`` on one set of inputs,
    ``cold_ms`` on :func:`cold_copies` sets taken in turn (``sets``, from
    :func:`clone_inputs`, when the caller keeps them for another function
    of the same inputs)."""
    n = cold_copies(read_bytes)
    sets = sets or clone_inputs(inputs, n)
    runs = [lambda s=s: fn(*s) for s in sets[:n]]
    return {"warm_ms": graph_ms(runs[:1], counters), "cold_ms": graph_ms(runs, counters),
            "cold_copies": n}
