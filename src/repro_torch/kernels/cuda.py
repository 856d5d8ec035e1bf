"""Build, load and count the hand-written CUDA kernels.

The kernels live in ``csrc/*.cu`` with a plain C interface: the three OLTP
kernels, the three of the LLM prefill (flash attention, the chunked SSM
scan, the chunked wkv6 recurrence) and flash attention's training
backward.  At first use on a CUDA tensor, :func:`lib` compiles each source
with ``nvcc`` for ``sm_90a`` (one process per source, all started
together), links them
into one shared library under ``build/repro_torch/`` at the repository root,
and loads it with ``ctypes``.  The library's file name carries a digest of
the sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is.  Nothing here runs at import time: a machine without
``nvcc`` or a card imports the package and uses the plain versions.

Every C entry point takes the ordinal of its tensors' device and the
caller's current stream (:func:`current_stream`).  It makes that device
current for its own scope only (``csrc/device_guard.cuh``: ``cudaSetDevice``
only when the caller's current device differs, restored on return),
launches on that stream and returns ``cudaGetLastError()``; :func:`check`
raises on anything but 0.  :data:`LAUNCHES` counts, per kernel, the wrapper
calls that launched it.  Each LLM kernel also has one dispatcher op
(:func:`define_op`) with a Meta kernel only, which gives the launch's
outputs on the meta device; the wrappers send meta calls through the op and
call the launch directly on the card.
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
from typing import Callable, Dict, List, Optional

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("seg_reduce.cu", "scatter_max.cu", "validate_sequence.cu",
           "flash_attention.cu", "flash_attention_bwd.cu", "ssm_scan.cu", "rwkv6.cu")
HEADERS = ("common.cuh", "device_guard.cuh")
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
    "flash_attention": 0,
    "flash_attention_bwd": 0,
    "ssm_scan_chunked": 0,
    "rwkv6_chunked": 0,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_log: str = ""
# torch._C._cuda_getCurrentRawStream, looked up at the first launch: only
# CUDA builds of torch have it
_raw_stream: Optional[Callable[[int], int]] = None


# a replica's tailing thread launches the scatter beside the caller's thread,
# and ``+=`` on a dict entry is a read-modify-write the interpreter may split
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of ``name`` to :data:`LAUNCHES` (from any thread)."""
    with _count_lock:
        LAUNCHES[name] += 1


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad mode is on and one of ``tensors``
    requires a gradient.  A wrapper fills its outputs through ctypes, so on
    the card they carry no ``grad_fn`` and a backward through them would
    silently drop every gradient before the call; the wrappers refuse such
    inputs on both devices alike."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it under "
                           f"torch.no_grad() or on detached inputs")


# the ``repro_torch`` operator namespace: one dispatcher op per LLM kernel
_ops_lib = None


def define_op(name: str, schema: str, meta: Callable):
    """Register the operator ``repro_torch::name`` with ``schema`` (its
    arguments and results) and ``meta`` as its only kernel, the Meta one,
    which allocates the launch's outputs on the meta device and runs
    nothing (the counterpart of a Pallas kernel's abstract evaluation).
    Returns the op's overload (``torch.ops.repro_torch.<name>.default``),
    whose every call is one op that a ``TorchDispatchMode`` sees."""
    global _ops_lib
    import torch

    if _ops_lib is None:
        _ops_lib = torch.library.Library("repro_torch", "DEF")
    _ops_lib.define(name + schema)
    _ops_lib.impl(name, meta, "Meta")
    return getattr(torch.ops.repro_torch, name).default


def reset_launches() -> None:
    with _count_lock:
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
    """The loaded kernel library, built on first call (the lock is taken
    only until it is loaded)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            # every launching entry point ends with (device ordinal, stream)
            dll.repro_seg_reduce.argtypes = [p, p, ll, p, i, i, i, p]
            dll.repro_seg_reduce.restype = i
            dll.repro_ssn_scatter_max.argtypes = [p, p, ll, p, p, p, ll, p, p, i, p]
            dll.repro_ssn_scatter_max.restype = i
            dll.repro_validate_sequence.argtypes = [p, p, ll, i, i, p, ctypes.c_uint, p, p, i, p]
            dll.repro_validate_sequence.restype = i
            meta = ctypes.POINTER(ll)
            f = ctypes.c_float
            dll.repro_flash_attention.argtypes = [p, p, p, p, p, meta, i, i, i, i, f, f, i, p]
            dll.repro_flash_attention.restype = i
            dll.repro_flash_attention_bwd.argtypes = [p] * 10 + [meta, i, f, i, p]
            dll.repro_flash_attention_bwd.restype = i
            dll.repro_ssm_scan_chunked.argtypes = [p, p, p, p, p, p, p, p, meta, i, i, p]
            dll.repro_ssm_scan_chunked.restype = i
            dll.repro_rwkv6_chunked.argtypes = [p, p, p, p, p, p, p, p, meta, i, i, p]
            dll.repro_rwkv6_chunked.restype = i
            dll.repro_cuda_error_string.argtypes = [i]
            dll.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = dll
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def current_stream(index: int) -> int:
    """The calling thread's current stream on CUDA device ``index``, as the
    raw ``cudaStream_t``: PyTorch's own getter, as Triton reads it, with no
    ``torch.cuda.Stream`` object built.  Every kernel launches on it, never
    on the legacy default stream or a stream of its own."""
    global _raw_stream
    if _raw_stream is None:
        import torch

        _raw_stream = torch._C._cuda_getCurrentRawStream
    return _raw_stream(index)
