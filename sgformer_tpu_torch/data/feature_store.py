"""Memory-mapped node features for 100M-node graphs: the port of
``sgformer_tpu/data/feature_store.py``.

The reference loads ogbn-papers100M's 111M x 128 feature matrix (~57 GB)
into host RAM before training (``100M/nb-sample.py:78-81``). Here the
features stay in an on-disk ``np.memmap``; the sampled trainer's per-batch
row gather touches only the sampled pages.

A bf16 store halves the file and each gather's page reads. The JAX package
writes one as ``ml_dtypes.bfloat16``, which the machine with the card does
not have; bf16 is two bytes of the f32 pattern either way, so this store maps
such a file as ``uint16`` and views the gathered rows as ``torch.bfloat16``:
it reads what the JAX package wrote, and writes what it reads.
"""

from __future__ import annotations

import numpy as np
import torch

# the on-disk element of a store of each torch type
_STORED = {torch.float32: np.float32, torch.bfloat16: np.uint16}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        out = dtype
    elif dtype in ("bf16", "bfloat16"):
        out = torch.bfloat16
    else:
        out = {np.dtype(np.float32): torch.float32}.get(np.dtype(dtype))
    if out not in _STORED:
        raise ValueError(f"a feature store holds float32 or bfloat16 rows, not {dtype!r}")
    return out


class FeatureStore:
    """Row-indexable view of a memory-mapped [N, F] array of ``dtype``
    (``np.float32``/``torch.float32``, or ``torch.bfloat16``/``"bf16"``).
    ``store[idx]`` with integer ids returns those rows as a CPU tensor of the
    stored type; the trainer casts them as its ``transfer_dtype`` asks."""

    def __init__(self, path: str, shape, dtype=np.float32, mode: str = "r"):
        self.path = str(path)
        self.shape = tuple(shape)
        self.dtype = _torch_dtype(dtype)
        self._mm = np.memmap(self.path, dtype=_STORED[self.dtype], mode=mode, shape=self.shape)

    @classmethod
    def create(cls, path: str, array, dtype=np.float32) -> "FeatureStore":
        """Write ``array`` ([N, F], numpy or a tensor) as a store of
        ``dtype``; a bf16 store rounds to nearest even, as ``ml_dtypes``
        does."""
        dt = _torch_dtype(dtype)
        rows = torch.as_tensor(np.ascontiguousarray(array)).to(dt).contiguous()
        data = rows.view(torch.int16).numpy().view(np.uint16) if dt == torch.bfloat16 \
            else rows.numpy()
        mm = np.memmap(path, dtype=data.dtype, mode="w+", shape=data.shape)
        mm[:] = data
        mm.flush()
        del mm
        return cls(path, data.shape, dt)

    @classmethod
    def from_npy(cls, path: str) -> "FeatureStore":
        """Open an existing float32 ``.npy`` file without loading it."""
        arr = np.load(path, mmap_mode="r")
        store = cls.__new__(cls)
        store.path = str(path)
        store.shape = arr.shape
        store.dtype = _torch_dtype(arr.dtype)
        store._mm = arr
        return store

    def __getitem__(self, idx) -> torch.Tensor:
        # np.take copies just the requested rows, faster than fancy
        # indexing for large cold gathers
        idx = np.asarray(idx)
        if idx.ndim == 1 and np.issubdtype(idx.dtype, np.integer):
            rows = np.take(self._mm, idx, axis=0)
        else:
            rows = np.array(self._mm[idx])
        if self.dtype == torch.bfloat16:
            return torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(rows)

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)
