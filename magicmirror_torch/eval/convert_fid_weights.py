"""Convert the pytorch-fid Inception checkpoint into the flat npz that
``eval/inception.py::load_fid_weights`` reads (Flax names and layouts, as
``magicmirror/eval/convert_fid_weights.py`` writes it: the same keys and
arrays), with torch alone, so it runs on a machine without jax:

    python -m magicmirror_torch.eval.convert_fid_weights pt_inception-2015-12-05-6726825d.pth

Writes ``magicmirror_torch/eval/fid_weights.npz`` (``DEFAULT_WEIGHTS``).
"""
from __future__ import annotations

import sys

import numpy as np


def convert(state_dict: dict) -> dict:
    """torch state_dict name/layout -> 'a/b/c' flat npz keys in NHWC/Flax."""
    out = {}
    for k, v in state_dict.items():
        v = np.asarray(v.cpu().numpy() if hasattr(v, "cpu") else v)
        parts = k.split(".")
        if parts[-1] == "num_batches_tracked" or parts[0] in ("fc", "AuxLogits"):
            continue
        # torch: <block>.<branch>.conv.weight / .bn.{weight,bias,running_*}
        *prefix, leaf = parts
        if leaf == "weight" and prefix[-1] == "conv":
            key = "params/" + "/".join(prefix) + "/kernel"
            v = v.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif prefix[-1] == "bn":
            if leaf == "weight":
                key = "params/" + "/".join(prefix) + "/scale"
            elif leaf == "bias":
                key = "params/" + "/".join(prefix) + "/bias"
            elif leaf == "running_mean":
                key = "batch_stats/" + "/".join(prefix) + "/mean"
            elif leaf == "running_var":
                key = "batch_stats/" + "/".join(prefix) + "/var"
            else:
                continue
        else:
            continue
        out[key] = v
    return out


def main(argv=None, out=None):
    """Convert the checkpoint named by ``argv[0]`` into ``out`` (default
    ``DEFAULT_WEIGHTS``) -> the path written."""
    import torch

    from .inception import DEFAULT_WEIGHTS

    argv = sys.argv[1:] if argv is None else argv
    out = out or DEFAULT_WEIGHTS
    sd = torch.load(argv[0], map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    flat = convert(sd)
    np.savez(out, **flat)
    print(f"wrote {out} ({len(flat)} arrays)")
    return out


if __name__ == "__main__":
    main()
