"""Neighbour sampling of the sampled tier (papers100M's mode) on the host."""

from sgformer_tpu_torch.sample.neighbor import (  # noqa: F401
    CSRGraph,
    NeighborSampler,
    PrefetchIterator,
    SampledBatch,
)
