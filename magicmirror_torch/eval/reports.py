"""Run reporting, the port of ``magicmirror/eval/reports.py``: the scalar
log (CSV, and TensorBoard too where ``torch.utils.tensorboard`` imports) and
the append-only ``result.txt``."""
from __future__ import annotations

import os


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
