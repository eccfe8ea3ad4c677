"""Utilities of the port."""

from sgformer_tpu_torch.utils.memory import device_memory_stats, memory_mb  # noqa: F401
