"""Device choice for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; None means the CUDA card.

    Without a visible CUDA device and with no device asked for, this
    raises: the port never falls back to the CPU on its own. Pass
    ``device="cpu"`` to run there (as the tests do)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
