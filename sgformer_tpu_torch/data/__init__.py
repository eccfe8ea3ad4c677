"""Datasets for the port: the container, splits and synthetic graphs."""

from sgformer_tpu_torch.data.loaders import SYNTHETIC, synthetic_dataset  # noqa: F401
from sgformer_tpu_torch.data.ncdataset import NCDataset  # noqa: F401
