"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the repository root (a directory
that ``.gitignore`` lists) and loaded with ``ctypes``. The hash covers the
source and the flags, so an edited kernel is rebuilt and an unchanged one
is loaded as it is. Nothing here runs at import: a module that holds a
kernel calls :func:`load` from inside its wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_mu = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on the machine with the card"
        )
    return found


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def sources() -> List[str]:
    """Names of every ``csrc/*.cu`` kernel source."""
    return sorted(n[:-3] for n in os.listdir(CSRC) if n.endswith(".cu"))


def build_all(
    names: Optional[List[str]] = None, ptxas: bool = False
) -> Dict[str, str]:
    """Compile the named kernel sources (default: all of them) at once, one
    ``nvcc`` per source, all started together, skipping any whose
    up-to-date library exists. ``ptxas`` rebuilds regardless, with
    ``-Xptxas -v`` (registers, shared memory, spills). Returns {name:
    compiler output} for the sources compiled; raises naming every source
    that failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names or sources():
        out = library_path(name)
        if os.path.exists(out) and not ptxas:
            continue
        # private temp name, published atomically: a concurrent build
        # never loads a half-written file
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [
            nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas else []),
            "-o", tmp, os.path.join(CSRC, f"{name}.cu"),
        ]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiled on first use."""
    with _mu:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib
