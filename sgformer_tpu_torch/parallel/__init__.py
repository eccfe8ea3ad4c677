"""Node-sharded full-graph training on ``torch.distributed``: the port of
``sgformer_tpu/parallel/`` (its data-parallel batch trainer aside).

Nodes are split into contiguous blocks over a mesh axis (``"sp"``), one rank
per block: the linear attention needs one all-reduce of its partial sums per
layer and pass, the GCN branch exchanges cross-shard source rows (an
all-gather of the activation, or the halo all-to-all of only the boundary
rows), BatchNorm all-reduces its statistics, and the gradients are averaged
once per step. :mod:`.mesh` starts the process group and names the axis,
:mod:`.comm` holds the differentiable collectives, :mod:`.partition` the
shard graph and its halo plans, :mod:`.sharded` the trainer, and
:mod:`.scaling` the edges/s harness.
"""

from sgformer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    feed_process_local,
    init_distributed,
    make_mesh,
)
from sgformer_tpu_torch.parallel.partition import (  # noqa: F401
    ShardGraph,
    edge_cut,
    idx_to_mask,
    partition_graph,
)
from sgformer_tpu_torch.parallel.sharded import ShardedTrainer  # noqa: F401
