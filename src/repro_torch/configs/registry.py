"""Architecture registry: ``--arch <id>`` lookup for configs + smoke variants."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

_ARCH_MODULES = {
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "cifar-cnn": "repro_torch.configs.cifar_cnn",
}

ASSIGNED_ARCHS = [a for a in _ARCH_MODULES if a != "cifar-cnn"]


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[arch]).smoke_config()


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


# (arch, shape) pairs that are skipped, with the reason (DESIGN.md policy).
SKIPS: dict[tuple[str, str], str] = {
    ("whisper-tiny", "long_500k"):
        "enc-dec full attention; audio context bounded by the conv frontend",
}


def dryrun_pairs() -> list[tuple[str, str]]:
    pairs = []
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            if (arch, shape) not in SKIPS:
                pairs.append((arch, shape))
    return pairs
