"""Build and load the port's CUDA kernels.

Each kernel source under ``xrsfm_tpu_torch/csrc`` exposes a plain C
interface.  It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/kernels/`` at the root of the checkout, named by a
hash of its source, and loaded with ``ctypes``.  The first call in a fresh
checkout builds it; later calls load the cached library.  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> str:
    """Path of the library built from csrc/<source> at its current content."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(sources) -> None:
    """Compile every csrc/<source> whose library is missing, one nvcc
    process each, all started together; raises if any fails."""
    jobs = []
    for source in sources:
        path = library_path(source)
        if os.path.exists(path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build beside the target and rename: concurrent builders each
        # write their own file and the rename is atomic
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
        jobs.append((source, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for source, path, tmp, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {source} ({proc.returncode}):\n"
                          f"{out}")
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))


def ptxas_report(sources) -> Dict[str, str]:
    """What ptxas says of each csrc/<source>'s kernels (registers, shared
    memory, stack, spill stores and loads): {source: its lines}.  One
    `nvcc -cubin -Xptxas -v` process each, all started together; builds
    nothing that load() uses."""
    jobs = {}
    tmp = tempfile.mkdtemp(prefix="ptxas_")
    try:
        for source in sources:
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o",
                   os.path.join(tmp, source + ".cubin"),
                   os.path.join(CSRC, source)]
            jobs[source] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        out = {}
        for source, proc in jobs.items():
            text = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc -Xptxas -v failed on {source}:\n"
                                   f"{text}")
            out[source] = "\n".join(
                ln.strip() for ln in text.splitlines()
                if "ptxas info" in ln or "spill" in ln)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load(source: str) -> ctypes.CDLL:
    """Build csrc/<source> if its library is missing, then load it."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is not None:
            return lib
        build([source])
        lib = ctypes.CDLL(library_path(source))
        _LOADED[source] = lib
        return lib
