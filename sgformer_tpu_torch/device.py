"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default and raises when CUDA is
absent: the port never falls back to the CPU on its own. Tests pass
``device="cpu"``, where each kernel's plain PyTorch version runs instead.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: sgformer_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
