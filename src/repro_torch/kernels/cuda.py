"""Build, load and count the hand-written CUDA kernels.

The three OLTP kernels live in ``csrc/*.cu`` with a plain C interface.  At
first use on a CUDA tensor, :func:`lib` compiles each source with ``nvcc``
for ``sm_90a`` (one process per source, all started together), links them
into one shared library under ``build/repro_torch/`` at the repository root,
and loads it with ``ctypes``.  The library's file name carries a digest of
the sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is.  Nothing here runs at import time: a machine without
``nvcc`` or a card imports the package and uses the plain versions.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.
:data:`LAUNCHES` counts, per kernel, the wrapper calls that launched it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("seg_reduce.cu", "scatter_max.cu", "validate_sequence.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",
)

#: launches per kernel, counted by each wrapper where it launches its kernel
LAUNCHES: Dict[str, int] = {
    "seg_reduce": 0,
    "ssn_scatter_max": 0,
    "validate_sequence": 0,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_log: str = ""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels (a no-op when the library for these
    sources exists).  Returns the library's path; the compiler's resource
    report (``-Xptxas=-v``) is kept in :func:`build_log`."""
    global _build_log
    so = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs: List[subprocess.Popen] = []
        objs: List[str] = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [p.communicate()[0] for p in procs]
        for name, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out = os.path.join(tmp, so.name)
        link = subprocess.run(
            [nvcc, "-shared", NVCC_FLAGS[0], *objs, "-o", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(out, so)
    _build_log = "".join(logs)
    return so


def build_log() -> str:
    return _build_log


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            dll.repro_seg_reduce.argtypes = [p, p, ll, p, i, i, p]
            dll.repro_seg_reduce.restype = i
            dll.repro_ssn_scatter_max.argtypes = [p, p, ll, p, p, p, ll, p, p, p, p]
            dll.repro_ssn_scatter_max.restype = i
            dll.repro_validate_sequence.argtypes = [p, p, ll, i, i, p, p, p, p]
            dll.repro_validate_sequence.restype = i
            dll.repro_cuda_error_string.argtypes = [i]
            dll.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = dll
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def stream_of(t) -> int:
    """The calling thread's current stream on ``t``'s device, as an int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
