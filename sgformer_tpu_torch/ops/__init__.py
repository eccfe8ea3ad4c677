"""Plain PyTorch versions of the operations the kernels compute."""

from sgformer_tpu_torch.ops.attention import linear_attention  # noqa: F401
from sgformer_tpu_torch.ops.spmm import spmm  # noqa: F401
