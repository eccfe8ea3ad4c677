"""Model modules of the port."""

from sgformer_tpu_torch.nn.graphconv import GraphConv, GraphConvLayer  # noqa: F401
from sgformer_tpu_torch.nn.layers import Dropout, LayerNorm, TorchLinear  # noqa: F401
from sgformer_tpu_torch.nn.norm import MaskedBatchNorm  # noqa: F401
from sgformer_tpu_torch.nn.sgformer import SGFormer, SGFormerConfig  # noqa: F401
from sgformer_tpu_torch.nn.transconv import TransConv, TransConvLayer  # noqa: F401
