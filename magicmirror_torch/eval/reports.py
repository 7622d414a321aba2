"""Run reporting, the port of ``magicmirror/eval/reports.py``: the scalar
log (CSV, and TensorBoard too where ``torch.utils.tensorboard`` imports),
the append-only ``result.txt`` and the histograms of predicted attributes
(npz always, the PNG where matplotlib imports)."""
from __future__ import annotations

import os

import numpy as np


class SummaryLogger:
    """Scalars into ``<logdir>/scalars.csv`` (``step,tag,value`` lines), and
    into a TensorBoard writer when one can be made."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._csv = open(os.path.join(logdir, "scalars.csv"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(logdir)

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        self._csv.write(f"{step},{tag},{value}\n")
        self._csv.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._csv.close()
        if self._tb is not None:
            self._tb.close()


class ResultLog:
    """Append-only ``<outf>/result.txt``."""

    def __init__(self, path: str):
        self.path = path

    def write(self, line: str) -> None:
        with open(self.path, "a") as fp:
            fp.write(line if line.endswith("\n") else line + "\n")


def save_histograms(stats: dict, path: str) -> None:
    """The predicted attributes' values ``stats`` (name -> array) into
    ``<path>.npz``, and where matplotlib imports (it is imported here, and
    only here) one histogram of 20 bins a non-empty attribute into the PNG
    ``path``."""
    np.savez(path + ".npz", **{k: np.asarray(v) for k, v in stats.items()})
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k in stats if np.asarray(stats[k]).size > 0]
    if not keys:
        return
    fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3), squeeze=False)
    for ax, k in zip(axes[0], keys):
        ax.hist(np.asarray(stats[k], np.float64).ravel(), bins=20)
        ax.set_title(k)
    fig.tight_layout()
    fig.savefig(path if path.endswith(".png") else path + ".png")
    plt.close(fig)
