"""Configurations of the port: the paper's own experiments and every
language-model arch of the reference.

``--arch <id>`` resolves through :data:`ARCHS` as in the reference's
``repro.configs``: the same ten archs, each with a ``ModelConfig``
equal to the reference's field by field; :func:`get_experiment`,
:func:`production_fl` and :func:`applicable_shapes` as there.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import (INPUT_SHAPES, ExperimentConfig, FLConfig,
                                MeshConfig, ModelConfig, TrainConfig)

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


def production_fl(multi_pod: bool = False) -> FLConfig:
    """Default FL mapping on the production mesh: 16 replicas/pod,
    4 replicas per cluster; multi-pod doubles the cluster count."""
    return FLConfig(
        algorithm="ce_fedavg",
        num_clusters=8 if multi_pod else 4,
        devices_per_cluster=4,
        tau=2, q=8, pi=10, topology="ring",
    )


def get_experiment(arch: str, *, multi_pod: bool = False,
                   fl: FLConfig | None = None,
                   train: TrainConfig | None = None) -> ExperimentConfig:
    mesh = MeshConfig(
        shape=(2, 16, 16) if multi_pod else (16, 16),
        axes=("pod", "data", "model") if multi_pod else ("data", "model"),
        multi_pod=multi_pod,
    )
    return ExperimentConfig(
        model=get_model_config(arch),
        fl=fl or production_fl(multi_pod),
        mesh=mesh,
        train=train or TrainConfig(optimizer="sgd", learning_rate=0.05,
                                   momentum=0.9),
    )


def applicable_shapes(arch: str) -> list:
    """The input shapes this arch runs (the reference's skip table: the
    500k-token decode only where the arch supports long context)."""
    cfg = get_model_config(arch)
    out = []
    for name, s in INPUT_SHAPES.items():
        if name == "long_500k" and not cfg.supports_long_context:
            continue
        out.append(name)
    return out
