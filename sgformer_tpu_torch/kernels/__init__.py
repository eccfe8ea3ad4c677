"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Each wrapper launches its kernel on CUDA tensors and runs the plain PyTorch
version on CPU tensors; see :mod:`.spmm` and :mod:`.attention`. The forward
kernels are ``torch.library`` custom ops (:mod:`.ops`), which the wrappers
call.
"""

from sgformer_tpu_torch.kernels import attention, spmm  # noqa: F401
from sgformer_tpu_torch.kernels import ops  # noqa: F401  (after the modules it registers)

# launches of the timing probes' kernels (``sgformer_tpu_torch.microbench``):
# held here, so that the one registry below covers every kernel and a model
# path's counts show that it launched none of them
probe_launches = {"gather_rows": 0, "gather_tiles": 0, "slab_variant": 0}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in probe_launches:
        probe_launches[name] = 0
    spmm.launches = 0
    spmm.ev_launches = 0
    spmm.ev_bwd_launches = 0
    spmm.sddmm_launches = 0
    spmm.q8_launches = 0
    spmm.quantize_launches = 0
    attention.reduce_launches = 0
    attention.apply_launches = 0
    attention.bwd_reduce_launches = 0
    attention.bwd_apply_launches = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last reset. ``csr_spmm``,
    ``csr_spmm_q8`` and ``quantize_absmax`` (one a ``csr_spmm_q8`` call, on
    x or on g) count forward (A @ x) and backward (A^T @ g) launches alike;
    ``csr_spmm_ev`` counts the per-edge-value forward, ``csr_spmm_ev_bwd``
    its gradient (dx and dv in one launch)."""
    return {
        "csr_spmm": spmm.launches,
        "linear_attention_reduce": attention.reduce_launches,
        "linear_attention_apply": attention.apply_launches,
        "linear_attention_bwd_reduce": attention.bwd_reduce_launches,
        "linear_attention_bwd_apply": attention.bwd_apply_launches,
        "csr_spmm_ev": spmm.ev_launches,
        "csr_spmm_ev_bwd": spmm.ev_bwd_launches,
        "sddmm": spmm.sddmm_launches,
        "csr_spmm_q8": spmm.q8_launches,
        "quantize_absmax": spmm.quantize_launches,
        **probe_launches,
    }
