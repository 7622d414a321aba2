"""Build ``csrc/*.cu`` with nvcc into one shared library with a plain C
interface, and bind it with ctypes.  Each source is compiled by its own nvcc
process, all started together, and the objects are linked into the library.

The build runs at first use, never at import.  Its output goes to
``build/magicmirror_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources and flags, so a changed source rebuilds and an unchanged
one loads the cached library.  Every C entry point returns
``cudaGetLastError()`` after its launch; ``launch`` raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "magicmirror_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# filled by build(): seconds, path and the compiler's output (ptxas -v)
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # rows, cull, verts (null in 'line' mode), exact, B, F + 1, H, W, sigmainv,
    # idx, soft, uv, normal, hard, stream
    "raster_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P),
    # rows, cull, verts, exact, B, F + 1, H, W, sigmainv, idx, sumlog, stream
    "raster_fwd_plain": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P),
    # uv, mask (null = unmasked), tex, B, H, W, Ht, Wt, out, stream
    "texture_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    # uv, mask, tex, B, H, W, Ht, Wt, level, never (NaN), out, stream
    "texture_parts": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P),
    # rows, cull, g_sumlog, B, F + 1, H, W, sigmainv, G, stream
    "raster_bwd": (_P, _P, _P, _I, _I, _I, _I, _F, _P, _P),
    # g, uv, mask (null = unmasked), tex, B, H, W, Ht, Wt, d_tex, d_uv, stream
    "texture_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
}
_LIB = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _run(cmds):
    """Start every command at once, wait for all, raise on the first failure;
    returns their combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, output in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{output}")
    return "".join(outputs)


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one library; returns its path."""
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the headers too
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libmmkernels.so"
    if lib.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "(cached)")
        BUILD_INFO["path"] = str(lib)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [out_dir / f"{src.stem}.{pid}.o" for src in srcs]
    tmp = out_dir / f"libmmkernels.{pid}.so"
    t0 = time.perf_counter()
    log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(srcs, objs)])
    log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    BUILD_INFO.update(seconds=seconds, log=log, path=str(lib))
    return lib


def library() -> ctypes.CDLL:
    """Build (once) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.mm_error_string.argtypes = [ctypes.c_int]
        lib.mm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(name: str, *args) -> None:
    """Call the C entry point ``name`` on the current stream; raise if the
    launch was refused."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.mm_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}: {msg}")
