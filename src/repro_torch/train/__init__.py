"""Training (the reference's ``train/``): the trainer and the
checkpoint format."""
from repro_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint, save_checkpoint,
)
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: F401
