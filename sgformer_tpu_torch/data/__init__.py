"""Datasets for the port: the container, splits, the readers of every
on-disk format the JAX package reads (``load_dataset``), synthetic graphs,
the host transforms, the sampled tier's feature store and CSR prep, and the
explicit fetch tool (``data.download``)."""

from sgformer_tpu_torch.data.loaders import SYNTHETIC, load_dataset, synthetic_dataset  # noqa: F401
from sgformer_tpu_torch.data.ncdataset import NCDataset  # noqa: F401
from sgformer_tpu_torch.data.feature_store import FeatureStore  # noqa: F401
