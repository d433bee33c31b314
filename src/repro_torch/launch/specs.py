"""``meta`` input stand-ins for every (arch × input shape) combo (port of
``repro.launch.specs``).

The functions return shapes and dtypes only, as ``meta`` tensors, which
allocate nothing: what the dry-run (``launch.dryrun``) runs a rank's
program on. Modality frontends are stubs, as in the reference: audio
provides frame embeddings, VLM provides patch embeddings, both already
at d_model width.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ExperimentConfig, ModelConfig, ShapeConfig
from repro_torch.models import model as mdl
from repro_torch.models.layers import torch_dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch(cfg: ModelConfig, lead: tuple, S: int) -> Dict[str, torch.Tensor]:
    """Tokens (int32) and the family's stub embeddings, ``lead + ...``."""
    act = torch_dtype(cfg.dtype)
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        out["tokens"] = _meta(lead + (S - cfg.num_patches,), torch.int32)
        out["patch_embeds"] = _meta(lead + (cfg.num_patches, cfg.d_model),
                                    act)
    elif cfg.family == "encdec":
        out["tokens"] = _meta(lead + (S,), torch.int32)
        out["frames"] = _meta(lead + (cfg.encoder_seq, cfg.d_model), act)
    else:
        out["tokens"] = _meta(lead + (S,), torch.int32)
    return out


def train_batch_shapes(exp: ExperimentConfig, shape: ShapeConfig,
                       R: int) -> Dict[str, torch.Tensor]:
    """(q, tau, R, B_local, ...) abstract batch for one global round."""
    cfg = exp.model
    if shape.global_batch % R:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {R} replicas")
    lead = (exp.fl.q, exp.fl.tau, R, shape.global_batch // R)
    out = _batch(cfg, lead, shape.seq_len)
    out["labels"] = _meta(out["tokens"].shape, torch.int32)
    return out


def prefill_batch_shapes(cfg: ModelConfig, shape: ShapeConfig
                         ) -> Dict[str, torch.Tensor]:
    return _batch(cfg, (shape.global_batch,), shape.seq_len)


def decode_input_shapes(cfg: ModelConfig, shape: ShapeConfig):
    """(cache_shapes, tokens, pos) abstract inputs for a decode step;
    ``pos`` is an int, the cache's last position (the reference's is a
    () int32 stand-in: the port's step takes a host int)."""
    B, S = shape.global_batch, shape.seq_len
    cache = mdl.init_decode_cache(cfg, B, S, device="meta")
    return cache, _meta((B, 1), torch.int32), S - 1
