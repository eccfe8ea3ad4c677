"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Each wrapper launches its kernel on CUDA tensors and runs the plain PyTorch
version on CPU tensors; see :mod:`.spmm` and :mod:`.attention`.
"""

from sgformer_tpu_torch.kernels import attention, spmm  # noqa: F401


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    spmm.launches = 0
    attention.reduce_launches = 0
    attention.apply_launches = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {
        "csr_spmm": spmm.launches,
        "linear_attention_reduce": attention.reduce_launches,
        "linear_attention_apply": attention.apply_launches,
    }
