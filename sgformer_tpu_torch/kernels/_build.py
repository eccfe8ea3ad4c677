"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled on first use into its own shared library
with a plain C interface, under ``<cache>/kernels/``, with ``<cache>`` from
:func:`sgformer_tpu_torch.utils.cache.resolve_cache_dir` at build time: a
non-empty ``SGFORMER_CACHE_DIR``, else ``build/`` beside the package (the
repository's ``.gitignore`` lists ``build/``). The file name carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all
of them.

Nothing here runs at import time: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

from sgformer_tpu_torch.utils.cache import resolve_cache_dir

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("spmm", "linear_attention", "linear_attention_bwd", "microbench")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
# argtypes of every C entry point, by source: a pointer passed without its
# argtype would be cut to 32 bits
_SIGNATURES = {
    "spmm": {
        "sgf_csr_spmm": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
        "sgf_csr_spmm_ev_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                                _I, _I, _I, _P, _P],
        "sgf_sddmm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "sgf_csr_spmm_q8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                            _I, _I, _P, _P],
        "sgf_quantize_absmax": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    },
    "linear_attention": {
        "sgf_la_reduce": [_P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P, _P],
        "sgf_la_apply": [_P, _P, _L, _L, _P, _L, _I, _I, _I, _I, _P, _P, _P,
                         _P, _I, _P, _P],
        "sgf_la_apply_scratch": [_I, _I, _I],
    },
    "microbench": {
        "sgf_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "sgf_gather_rows_resident": [_I, _I],
        "sgf_gather_tiles": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "sgf_gather_tiles_resident": [_I, _I],
        "sgf_slab_variant": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    },
    "linear_attention_bwd": {
        "sgf_la_bwd_reduce": [_P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
        "sgf_la_bwd_reduce_scratch": [_I, _I, _I],
        "sgf_la_bwd_apply": [_P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _P, _L, _L, _L,
                             _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                             _P],
        "sgf_la_bwd_apply_scratch": [_I, _I, _I],
        "sgf_la_bwd_apply_persistent": [_I, _I, _I],
    },
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built on a machine "
            "with the CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return path


def build_dir(cache_dir: Optional[str] = None) -> str:
    """Where the libraries go: ``<cache>/kernels``, the cache as
    :func:`~sgformer_tpu_torch.utils.cache.resolve_cache_dir` resolves it."""
    return os.path.join(resolve_cache_dir(cache_dir), "kernels")


def _target(name: str, cache_dir: Optional[str] = None) -> tuple[str, str]:
    """The source and its library's path (under :func:`build_dir`); the hash
    covers the source, the headers of ``csrc/`` it may include, and the
    flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in (src, *(os.path.join(CSRC, h) for h in headers)):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(build_dir(cache_dir), f"{name}-{digest.hexdigest()[:16]}.so")


def _load(name: str, so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source not yet built, all ``nvcc`` runs at once, and
    load them. Returns the ``ptxas`` report of each build (registers, shared
    memory and spills per kernel); raises if a build fails."""
    reports = {}
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        os.makedirs(build_dir(), exist_ok=True)
        procs = {}
        for name in todo:
            src, so = _target(name)
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[name] = (so, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failed = []
        for name, (so, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            reports[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
                if os.path.exists(tmp):
                    os.unlink(tmp)
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            _LIBS[name] = _load(name, _target(name)[1])
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
