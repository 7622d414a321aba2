"""Time ``DiffRender.render`` of the default configuration on the card, for
comparing two checkouts of the port side by side on one GPU.

    python3 magicmirror_torch/bench_render.py [--tree DIR] [--label NAME]

``--tree`` is the root of the checkout whose ``magicmirror_torch`` is
imported (default: the one this file lies in); its kernels are built into
that checkout's own ``build/``.  Uses only what every version of the port
has: ``DiffRender(template, size, device=)``, ``bench_attributes``,
``to_torch``.  The render is b32 / 128^2 on ``template/sphere.obj`` under
bench.py's attribute distribution.  Prints one JSON line:
  * ``forward_event_ms``: one render under ``no_grad`` between CUDA events,
    median of ``--iters`` after ``--warmup``;
  * ``forward_wall_ms``: ``--iters`` renders back to back on the host clock,
    one synchronisation at the end, per render (what a host-bound serving
    step pays);
  * ``forward_backward_event_ms`` / ``_wall_ms``: the same with the gradient
    of a linear functional of the image to the vertices and textures.
Run the checkouts in the order a, b, b, a, one after the other on the same
machine: host-bound times differ between machines by more than a change does.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(fn, warmup, iters):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        events.append(start.elapsed_time(end))
    return statistics.median(events), wall


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=HERE)
    parser.add_argument("--label", default="")
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--warmup", type=int, default=20)
    a = parser.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path.insert(0, tree)
    import torch
    from magicmirror_torch.render.renderer import DiffRender
    from magicmirror_torch.render.synthetic import bench_attributes, to_torch

    if not torch.cuda.is_available():
        sys.exit("bench_render.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    dr = DiffRender(os.path.join(tree, "template", "sphere.obj"), 128, device=dev)
    att = to_torch(bench_attributes(dr.vertices_init.cpu().numpy(), 32, 128, 0), dev)

    def forward():
        with torch.no_grad():
            return dr.render(**att)[0]

    leaves = dict(att)
    for key in ("vertices", "textures"):
        leaves[key] = att[key].clone().requires_grad_(True)
    w = torch.randn((32, 128, 128, 4), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))

    def forward_backward():
        for key in ("vertices", "textures"):
            leaves[key].grad = None
        (dr.render(**leaves)[0] * w).sum().backward()

    fe, fw = measure(forward, a.warmup, a.iters)
    be, bw = measure(forward_backward, a.warmup, a.iters)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"label": a.label, "tree": tree, "card": card, "shape": "b32/128^2",
                      "iters": a.iters, "forward_event_ms": fe, "forward_wall_ms": fw,
                      "forward_backward_event_ms": be, "forward_backward_wall_ms": bw,
                      "alpha_mean": float(forward()[..., 3].mean())}), flush=True)


if __name__ == "__main__":
    main()
