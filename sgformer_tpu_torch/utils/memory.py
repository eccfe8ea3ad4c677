"""Device memory telemetry: the port of ``sgformer_tpu/utils/memory.py``,
from PyTorch's CUDA caching allocator."""

from __future__ import annotations

import torch


def device_memory_stats(device=None) -> dict:
    """{'bytes_in_use', 'peak_bytes_in_use', 'bytes_reserved',
    'bytes_limit'} of one CUDA device (the current one by default); an empty
    dict for the CPU. The peak is since the last
    ``torch.cuda.reset_peak_memory_stats``."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        return {}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
        "bytes_reserved": torch.cuda.memory_reserved(dev),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


def memory_mb(device=None) -> float:
    """Bytes in use in MiB."""
    return device_memory_stats(device).get("bytes_in_use", 0) / 2**20
