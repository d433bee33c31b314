"""Configurations of the port: the paper's own experiments and the
language-model archs whose families the port runs.

``--arch <id>`` resolves through :data:`ARCHS` as in the reference's
``repro.configs``. Every arch of a ported family (``dense``, ``ssm``,
``hybrid``) is registered; ``whisper-medium`` (encoder-decoder),
``pixtral-12b`` (VLM), ``mixtral-8x7b`` and
``llama4-maverick-400b-a17b`` (MoE) arrive with a later slice
(ROADMAP A15).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import ModelConfig

ARCHS: Dict[str, str] = {
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2.5-14b": "qwen2p5_14b",
    "mamba2-2.7b": "mamba2_2p7b",
    "qwen2-0.5b": "qwen2_0p5b",
    "minitron-8b": "minitron_8b",
    "mistral-large-123b": "mistral_large_123b",
}

#: archs of the reference whose families the port does not run yet
UNPORTED = ("whisper-medium", "pixtral-12b", "mixtral-8x7b",
            "llama4-maverick-400b-a17b")

PAPER_EXPERIMENTS = ("femnist_cnn", "cifar_vgg11")


def get_model_config(arch: str) -> ModelConfig:
    if arch in UNPORTED:
        raise KeyError(f"arch {arch!r} is not ported yet: "
                       f"{', '.join(UNPORTED)} belong to the MoE, "
                       f"encoder-decoder and VLM families (ROADMAP A15); "
                       f"options: {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; options: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.MODEL
