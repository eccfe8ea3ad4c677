"""Full-graph training of the port: optimizer, trainer, logger, timing and
checkpoints."""

from sgformer_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from sgformer_tpu_torch.train.logger import RunLogger  # noqa: F401
from sgformer_tpu_torch.train.optim import adam, dual_weight_decay_adam  # noqa: F401
from sgformer_tpu_torch.train.timing import TimeTestResult, time_test  # noqa: F401
from sgformer_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
    bce_loss,
    cross_entropy_loss,
)
