"""Native (C++) host-side runtime components.

The device compute path is JAX/Pallas; this package holds the host-side
native pieces the reference implements in C++ — currently the HNSW graph
index (hnsw.cc) and the binary dataset reader (vecs_io.cc). Shared
libraries are built lazily with the system compiler on first use and
cached next to the sources (rebuilt when a source file is newer).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_CXXFLAGS = ["-O3", "-march=native", "-funroll-loops", "-std=c++17",
             "-fopenmp", "-shared", "-fPIC", "-Wall"]
# per-library extra compile/link flags (system libs a component needs)
_EXTRA_FLAGS = {
    "ffdecode": ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"],
}


class NativeBuildError(RuntimeError):
    pass


def _build(name: str) -> str:
    src = os.path.join(_DIR, f"{name}.cc")
    out = os.path.join(_DIR, f"lib{name}.so")
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src)):
        cxx = os.environ.get("CXX", "g++")
        cmd = [cxx, *_CXXFLAGS, "-o", out, src,
               *_EXTRA_FLAGS.get(name, [])]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build failed: {' '.join(cmd)}\n{proc.stderr}")
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and dlopen the named native library."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_build(name))
        return _LIBS[name]


def available(name: str) -> bool:
    """True if the native library can be built/loaded on this machine."""
    try:
        load_library(name)
        return True
    except (NativeBuildError, OSError):
        return False
