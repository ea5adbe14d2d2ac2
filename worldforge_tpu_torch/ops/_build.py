"""Build the CUDA C++ kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/kernels/<name>-<hash>.so`` at the repository root; the hash
covers the source, every shared header ``csrc/*.cuh`` and the flags, so an
edited source or header is never served by a stale library. A
``csrc/<name>.cpp`` (host code the wrappers and the CPU tests read: kernel
1's layouts, kernel 4's launch plan) is built the same way by the host's
C++ compiler.
Nothing is built when a module is imported: the CPU tests import every
module on a host without ``nvcc``.
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
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
CUDA_SOURCES = ("flash_attention", "conv3d", "bsa", "flash_attention_bwd")
HOST_SOURCES = ("flash_plan", "conv_plan")

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


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "c++")) or shutil.which("g++")
    if found:
        return found
    raise RuntimeError("no host C++ compiler (c++ or g++) found")


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _target(name: str) -> Path:
    h = hashlib.sha256(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(HOST_FLAGS if name in HOST_SOURCES
                      else NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start the compiler for one source; returns (process, tmp path,
    target) or None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ([_cxx(), *HOST_FLAGS] if name in HOST_SOURCES else
           [_nvcc(), *NVCC_FLAGS]) + ["-o", tmp, str(_source(name))]
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
        raise RuntimeError(f"{os.path.basename(proc.args[0])} failed for "
                           f"{_source(name).name}:\n{log}")
    os.replace(tmp, out)
    return log


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources, all compilers started together.
    Returns each source's compiler log (``-Xptxas -v``: registers, shared
    memory and spills of every kernel); empty where it was already built."""
    names = list(names)
    with _LOCK:
        started = [(n, _start(n)) for n in names]
        return {n: _finish(n, s) for n, s in started}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu`` (or ``.cpp``), built on first
    use."""
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
