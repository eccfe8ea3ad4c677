"""Model modules of the port."""

from sgformer_tpu_torch.nn.baselines import (  # noqa: F401
    APPNP,
    GAT,
    GATJK,
    GCNJK,
    GPRGNN,
    H2GCN,
    LINK,
    MLP,
    SGC,
    SGC2,
    SIGN,
    GATConv,
    MixHop,
    MixHopLayer,
    MultiLP,
    SGCMem,
)
from sgformer_tpu_torch.nn.difformer import DIFFormer, DIFFormerConv  # noqa: F401
from sgformer_tpu_torch.nn.gcn import GCN, GCNConv  # noqa: F401
from sgformer_tpu_torch.nn.graphconv import GraphConv, GraphConvLayer  # noqa: F401
from sgformer_tpu_torch.nn.graphgps import GraphGPS  # noqa: F401
from sgformer_tpu_torch.nn.graphormer import (  # noqa: F401
    Graphormer,
    QuantNoiseLinear,
    collate_graphs,
    graphormer_inputs,
    inputs_to,
)
from sgformer_tpu_torch.nn.graphtrans import GraphTrans  # noqa: F401
from sgformer_tpu_torch.nn.layers import (  # noqa: F401
    Dropout,
    GraphModel,
    LayerNorm,
    TorchLinear,
)
from sgformer_tpu_torch.nn.nodeformer import (  # noqa: F401
    NodeFormer,
    NodeFormerConv,
    build_nodeformer_adjs,
    build_nodeformer_graphs,
)
from sgformer_tpu_torch.nn.norm import MaskedBatchNorm  # noqa: F401
from sgformer_tpu_torch.nn.sgformer import SGFormer, SGFormerConfig  # noqa: F401
from sgformer_tpu_torch.nn.transconv import TransConv, TransConvLayer  # noqa: F401
