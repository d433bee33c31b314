"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and its C sources (``csrc/``).

``twin_counts`` holds what the shape-only twins of the flash-attention
and SSD kernels (``flags.analysis`` on ``meta`` tensors) stand for:
``{"flops": ..., "bytes": ...}`` summed over their calls, by the
kernel modules' count formulas. ``launch.roofline.count_cost`` reads
it around the work it counts."""
from __future__ import annotations

twin_counts = {"flops": 0, "bytes": 0}


def count_twin(nbytes: float, flops: float) -> None:
    """Add one twin call's bytes and operations to ``twin_counts``."""
    twin_counts["bytes"] += int(nbytes)
    twin_counts["flops"] += int(flops)
