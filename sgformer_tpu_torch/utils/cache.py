"""Where the port keeps what it builds: the counterpart of
``sgformer_tpu/utils/cache.py``, whose XLA compile cache becomes here the
directory of the kernels' shared libraries (``kernels/_build.py`` builds
into ``<cache>/kernels``)."""

from __future__ import annotations

import os
from typing import Optional


def resolve_cache_dir(cache_dir: Optional[str] = None) -> str:
    """The build cache's directory: the explicit argument, else a non-empty
    ``SGFORMER_CACHE_DIR``, else ``build/`` at the repository's root (which
    its ``.gitignore`` lists). The JAX package's rule, with its default."""
    if cache_dir:
        return cache_dir
    env = os.environ.get("SGFORMER_CACHE_DIR")
    if env:
        return env
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo_root, "build")
