"""Optimizers and LR schedules (the reference's ``optim/``). Each
optimizer's functions take and return the nested params tree."""
from repro_torch.optim.adafactor import (  # noqa: F401
    adafactor_init, adafactor_update,
)
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedule import (  # noqa: F401
    cosine_schedule, linear_warmup,
)


def make_optimizer(name: str):
    """Returns (init_fn, update_fn) for 'adamw' | 'adafactor'."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)
