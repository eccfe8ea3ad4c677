"""Training of the port: optimizer, the full-graph trainer, the
random-partition mini-batch trainer, the neighbour-sampled trainer, logger,
timing and checkpoints."""

from sgformer_tpu_torch.train.batch_trainer import (  # noqa: F401
    BatchTrainConfig,
    BatchTrainer,
    build_subgraph_batch,
)
from sgformer_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from sgformer_tpu_torch.train.logger import RunLogger  # noqa: F401
from sgformer_tpu_torch.train.optim import adam, dual_weight_decay_adam  # noqa: F401
from sgformer_tpu_torch.train.sampled_trainer import (  # noqa: F401
    SampledTrainConfig,
    SampledTrainer,
    build_sampled_graph,
)
from sgformer_tpu_torch.train.timing import TimeTestResult, time_test  # noqa: F401
from sgformer_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
    bce_loss,
    cross_entropy_loss,
)
