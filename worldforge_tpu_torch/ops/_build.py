"""Build the CUDA C++ kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/kernels/<name>-<hash>.so`` at the repository root; the hash
covers the source, every shared header ``csrc/*.cuh`` and the flags, so an
edited source or header is never served by a stale library. Nothing is built when a module is imported: the CPU tests
import every module on a host without ``nvcc``.
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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")
CUDA_SOURCES = ("flash_attention", "conv3d", "bsa", "flash_attention_bwd")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or
    None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources, all nvcc processes started together.
    Returns each source's compiler log (``-Xptxas -v``: registers, shared
    memory and spills of every kernel); empty where it was already built."""
    names = list(names)
    with _LOCK:
        started = [(n, _start(n)) for n in names]
        return {n: _finish(n, s) for n, s in started}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
    return lib


def bind(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """``load(name)`` with ``argtypes``/``restype`` declared once for each
    ``{function: ([argtypes], restype)}``. Pointers and the stream are
    ``c_void_p``: an undeclared argument would be passed as a 32-bit int."""
    lib = load(name)
    if not getattr(lib, "_wf_bound", False):
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib._wf_bound = True
    return lib
