"""The host graph kernels in C++ (``csrc/graph_kernels.cpp``), built with
g++ on first use and called through ``ctypes``: the port of the JAX
package's native full-batch and hop samplers and of its clustering
reorder's label propagation and packing (:mod:`.reorder`). They have no
numpy fallback: a failed build raises (:func:`native_available` says
whether it builds)."""

from sgformer_tpu_torch.native.api import (  # noqa: F401
    cluster_pack_native,
    lpa_cluster_native,
    sample_batch_native,
    sample_neighbors_native,
)
from sgformer_tpu_torch.native.build import library, native_available  # noqa: F401
from sgformer_tpu_torch.native.reorder import reorder_for_clusters  # noqa: F401
