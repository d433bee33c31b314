"""Plain PyTorch versions of the port's kernels: the CPU path of every
wrapper and the ground truth its kernel is held against on the card."""
from __future__ import annotations

import torch


def gossip_mix_ref(W: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Y: (n, T); returns WᵀY, summed in f32, in Y's dtype."""
    return (W.to(torch.float32).T @ Y.to(torch.float32)).to(Y.dtype)


def gossip_mix_rows_ref(W: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Y: (n, T); returns W @ Y (row application), summed in f32, in
    Y's dtype."""
    return (W.to(torch.float32) @ Y.to(torch.float32)).to(Y.dtype)
