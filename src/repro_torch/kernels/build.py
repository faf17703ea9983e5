"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so``
at the checkout's root, at first use, once per process.  The hash covers
the source, every shared header ``csrc/*.cuh`` and the flags, so an
edited kernel or header is rebuilt and a stale library is never loaded.
No PyTorch header is compiled: a build takes seconds.  ``ptxas`` reports
each kernel's registers, shared memory and spills (``-Xptxas -v``);
:data:`PTXAS_LOG` keeps that report per library built in this process.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNELS", "load", "build_all", "check", "BUILD_DIR",
           "PTXAS_LOG"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("semiring", "waterfill", "sparse", "gfmm", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output (the ptxas report) of each library built in this process.
PTXAS_LOG: Dict[str, str] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, every shared
    header (a source may include any of them) and the flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc build; returns (target, process or None if built)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, target: Path, tmp, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(rc {proc.returncode}):\n{out}")
    PTXAS_LOG[name] = out
    os.replace(tmp, target)


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Compile every kernel library at once (one nvcc per source, all
    started together) and load them."""
    names = list(names)
    with _LOCK:
        started = {n: _start(n) for n in names if n not in _LIBS}
        for n, (target, tmp, proc) in started.items():
            _finish(n, target, tmp, proc)
            _LIBS[n] = ctypes.CDLL(str(target))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` reported a CUDA error."""
    if code != 0:
        fn = lib.kernel_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"CUDA error {code} launching {what}: "
                           f"{fn(code).decode()}")
