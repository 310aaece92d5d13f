"""Build helper shared by the port's CUDA kernels.

Each kernel source in `csrc/` is compiled on first use with `nvcc` for
`sm_90a` into a shared library with a plain C interface, then bound with
ctypes. Libraries land in `_build/` beside this file, named by the hash of
the source, so an edited source is rebuilt; the ptxas register and spill
report of each build is kept in `build_<name>_<hash>.log` there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` into `_build/lib<name>_<hash>.so` if it is
    not there yet; returns the library's path."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, src,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    with open(os.path.join(BUILD_DIR, f"build_{name}_{digest}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and open the library of `csrc/<name>.cu`."""
    return ctypes.CDLL(build(name))
