"""Configurations of the port: the paper's own experiments and the
language-model archs whose families the port runs.

``--arch <id>`` resolves through :data:`ARCHS` as in the reference's
``repro.configs``. Only the archs of the ported families (``dense``,
``ssm``, ``hybrid``) are registered; the others (MoE, encoder-decoder,
VLM) arrive with a later slice (ROADMAP A15).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import ModelConfig

ARCHS: Dict[str, str] = {
    "zamba2-2.7b": "zamba2_2p7b",
    "mamba2-2.7b": "mamba2_2p7b",
    "qwen2-0.5b": "qwen2_0p5b",
}


def get_model_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported (the MoE, "
                       f"encoder-decoder and VLM families are ROADMAP A15); "
                       f"options: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.MODEL
