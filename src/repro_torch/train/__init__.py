"""Training utilities of the port; only the checkpoint format so far."""
from repro_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint, save_checkpoint,
)
