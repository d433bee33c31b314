from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointStructureError, load_checkpoint, save_checkpoint)
from repro_torch.checkpoint.runckpt import RunCheckpoint  # noqa: F401
