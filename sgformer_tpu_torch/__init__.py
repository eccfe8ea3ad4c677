"""SGFormer on PyTorch and CUDA: the port of ``sgformer_tpu`` to an NVIDIA
Hopper GPU: training on the full graph (``train.Trainer``), in
random-partition mini-batches (``train.BatchTrainer``) and on
neighbour-sampled batches (``train.SampledTrainer``), the large-tier model
zoo beside SGFormer (``nn``), serving (``Predictor``, ``load_predictor``, and
the exported forward of ``Predictor.export_artifact`` that ``load_exported``
reads back in another process), the dataset readers
(``data.load_dataset``) and the command line that drives them all
(``python -m sgformer_tpu_torch.cli.main``, with the repo's recipes in
``recipes/``).

The JAX package ``sgformer_tpu`` is the reference this package is held
against; nothing here imports it, JAX or flax. Plain tensor code is PyTorch.
Each TPU kernel on the ported path has a hand-written CUDA kernel under
``csrc/`` (built with ``nvcc`` at first use, loaded with ``ctypes``) and a
plain PyTorch version that runs on CPU tensors. Entry points run on the GPU
(``device="cuda"``) and raise without one, unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from sgformer_tpu_torch.convert import load_flax_variables  # noqa: F401
from sgformer_tpu_torch.graph import Graph, preprocess_graph  # noqa: F401
from sgformer_tpu_torch.nn.sgformer import SGFormer, SGFormerConfig  # noqa: F401
from sgformer_tpu_torch.serve import Predictor, load_exported, load_predictor  # noqa: F401
from sgformer_tpu_torch.train import TrainConfig, Trainer  # noqa: F401
