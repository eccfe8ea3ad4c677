"""Plain PyTorch versions of the operations the kernels compute."""

from sgformer_tpu_torch.ops.attention import linear_attention  # noqa: F401
from sgformer_tpu_torch.ops.sddmm import sddmm, sddmm_softmax_weights  # noqa: F401
from sgformer_tpu_torch.ops.spmm import (  # noqa: F401
    edge_softmax,
    segment_mean,
    spmm,
    spmm_edge_values,
)
