"""The host sampler in C++ (``csrc/graph_kernels.cpp``), built with g++ on
first use and called through ``ctypes``: the port of the JAX package's
native full-batch sampler. It has no numpy fallback: a failed build raises."""

from sgformer_tpu_torch.native.api import sample_batch_native  # noqa: F401
from sgformer_tpu_torch.native.build import library  # noqa: F401
