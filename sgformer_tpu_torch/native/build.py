"""Build the port's host graph kernels (``csrc/graph_kernels.cpp``: the
sampled tier's full-batch and hop samplers and the clustering reorder's
label propagation and packing) with g++ and load them with ``ctypes``: the counterpart of the JAX
package's ``native/build.py``.

The library is compiled on first use with the JAX package's flags
(``-O3 -march=native -shared -fPIC -pthread``) into ``<cache>/native/``,
``<cache>`` from :func:`sgformer_tpu_torch.utils.cache.resolve_cache_dir` at
build time (``build/`` beside the package by default, which the repository's
``.gitignore`` lists). Its file name carries a hash of the source, the flags,
the machine type, the compiler's version and the target options that
``-march=native`` resolves to: such code is for the host that built it, so a
build directory copied to another host is rebuilt there.

Where the JAX loader returns None and its callers quietly fall back to
numpy, this one raises, with the compiler's error: the sampled tier's
samplers and the reorder are this library (:func:`native_available` says
whether it builds; nothing of the port consults it).

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional

from sgformer_tpu_torch.utils.cache import resolve_cache_dir

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "graph_kernels.cpp")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# argtypes of every entry point: a pointer passed without its argtype would
# be cut to 32 bits
_SIGNATURES = {
    "sample_batch": ([_P, _P, _P, _I64, _P, _I64, _I64, _I64, ctypes.c_uint64,
                      _P, _P, _P, _P, _P, _P], _I64),
    "sample_neighbors": ([_P, _P, _P, _I64, _I64, ctypes.c_uint64, _P, _P], _I64),
    "lpa_cluster": ([_P, _P, _I64, _I64, _I64, _I64, ctypes.c_uint64, _P], _I64),
    "cluster_pack": ([_P, _I64, _I64, _P], None),
}


def _compiler() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host graph kernels (csrc/graph_kernels.cpp: "
                           "the sampler, the clustering reorder) are built with it")
    return path


def build_dir(cache_dir: Optional[str] = None) -> str:
    """Where the library goes: ``<cache>/native``."""
    return os.path.join(resolve_cache_dir(cache_dir), "native")


def target(compiler: str, cache_dir: Optional[str] = None) -> str:
    """The library's path: the hash covers the source, the flags, the
    machine type, ``compiler --version`` and the target options
    ``-march=native`` resolves to on this host."""
    host = [subprocess.run([compiler, *args], capture_output=True, text=True,
                           timeout=60).stdout
            for args in (("--version",), ("-march=native", "-Q", "--help=target"))]
    digest = hashlib.sha256("\0".join((*FLAGS, platform.machine(), *host)).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(build_dir(cache_dir), f"graph_kernels-{digest.hexdigest()[:16]}.so")


def library() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if g++ is missing or
    the build fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        compiler = _compiler()
        so = target(compiler)
        if not os.path.exists(so):
            os.makedirs(os.path.dirname(so), exist_ok=True)
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run([compiler, *FLAGS, SOURCE, "-o", tmp], capture_output=True,
                                  text=True, timeout=300)
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise RuntimeError(f"the host graph kernels' build failed (g++ exit "
                                   f"{proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for name, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
        _LIB = lib
        return lib


def native_available() -> bool:
    """Whether the library builds and loads on this host (building it if
    it is not built yet): the counterpart of the JAX package's
    ``native_available``."""
    try:
        library()
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return False
    return True
