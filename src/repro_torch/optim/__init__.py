from repro_torch.optim.optimizers import (  # noqa: F401
    adamw,
    apply_updates,
    make_lr_schedule,
    make_optimizer,
    sgd,
)
