"""Configurations of the port: the paper's own experiments and every
language-model arch of the reference.

``--arch <id>`` resolves through :data:`ARCHS` as in the reference's
``repro.configs``: the same ten archs, each with a ``ModelConfig``
equal to the reference's field by field.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import ModelConfig

ARCHS: Dict[str, str] = {
    "whisper-medium": "whisper_medium",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2.5-14b": "qwen2p5_14b",
    "mamba2-2.7b": "mamba2_2p7b",
    "pixtral-12b": "pixtral_12b",
    "qwen2-0.5b": "qwen2_0p5b",
    "minitron-8b": "minitron_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mistral-large-123b": "mistral_large_123b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
}

PAPER_EXPERIMENTS = ("femnist_cnn", "cifar_vgg11")


def get_model_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; options: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.MODEL
