"""Sharded training on ``torch.distributed``: the port of
``sgformer_tpu/parallel/``.

Nodes are split into contiguous blocks over a mesh axis (``"sp"``), one rank
per block: the linear attention needs one all-reduce of its partial sums per
layer and pass, the GCN branch exchanges cross-shard source rows (an
all-gather of the activation, or the halo all-to-all of only the boundary
rows), BatchNorm all-reduces its statistics, and the gradients are averaged
once per step. On a (dp, sp) grid of ranks, dp mini-batches train at once,
each node-sharded over its group's sp ranks. :mod:`.mesh` starts the
process group and names the axes, :mod:`.comm` holds the differentiable
collectives, :mod:`.partition` the shard graph and its halo plans,
:mod:`.sharded` the full-graph trainer, :mod:`.dp_batch` and
:mod:`.dp_trainer` the data-parallel mini-batch step and trainer, and
:mod:`.scaling` the edges/s harness.
"""

from sgformer_tpu_torch.parallel.mesh import (  # noqa: F401
    GridMesh,
    Mesh,
    feed_process_local,
    init_distributed,
    make_global_mesh,
    make_mesh,
)
from sgformer_tpu_torch.parallel.partition import (  # noqa: F401
    ShardGraph,
    edge_cut,
    idx_to_mask,
    partition_graph,
)
from sgformer_tpu_torch.parallel.sharded import ShardedTrainer  # noqa: F401
from sgformer_tpu_torch.parallel.dp_trainer import DPBatchTrainer  # noqa: F401
