"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``slate_tpu_torch/csrc/<name>.cu`` has a plain C interface (no PyTorch
headers), so ``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, of every ``csrc`` header it
includes (``#include "<header>"``, followed recursively) and of the flags, so
an edited source or header is rebuilt and a stale library is never loaded.
Without ``nvcc`` (or if the build fails) :func:`load` raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# where nvcc is looked for after PATH: $CUDA_HOME/bin, then the toolkit's
# usual install prefix
CUDA_DIRS: List[str] = [
    d for d in (os.environ.get("CUDA_HOME"), "/usr/local/cuda") if d
]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A CUDA kernel of the port could not be built or loaded."""


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for d in CUDA_DIRS:
        cand = os.path.join(d, "bin", "nvcc")
        if os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (searched PATH and "
        + ", ".join(os.path.join(d, "bin") for d in CUDA_DIRS)
        + "): the CUDA kernels of slate_tpu_torch are built from "
        "slate_tpu_torch/csrc/*.cu at first use and need the CUDA toolkit"
    )


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> List[str]:
    """csrc/<name>.cu and every header of csrc/ it includes with quotes,
    followed recursively, each once, in the order first reached."""
    order: List[str] = []

    def visit(fname: str) -> None:
        if fname in order:
            return
        order.append(fname)
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            inc = inc.decode()
            if os.path.isfile(os.path.join(CSRC_DIR, inc)):
                visit(inc)

    visit(name + ".cu")
    return order


def _lib_path(name: str) -> str:
    digest = hashlib.sha256()
    for fname in _sources(name):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _build(name: str) -> None:
    out = _lib_path(name)
    if os.path.exists(out):
        return
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [nvcc, *NVCC_FLAGS, "-o", out + ".tmp", os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu (rc={proc.returncode}):\n{proc.stdout}")
    os.replace(out + ".tmp", out)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        if not os.path.exists(os.path.join(CSRC_DIR, name + ".cu")):
            raise KernelBuildError(f"no kernel source csrc/{name}.cu")
        _build(name)
        try:
            lib = ctypes.CDLL(_lib_path(name))
        except OSError as e:
            raise KernelBuildError(f"cannot load the library of csrc/{name}.cu: {e}") from e
        _LOADED[name] = lib
    return lib
