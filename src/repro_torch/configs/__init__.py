"""Architecture registry: the 10 assigned architectures + the paper's GPT
family. ``get_config("mixtral-8x7b")`` / ``--arch mixtral-8x7b``.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig, SHAPES, TrainConfig

from repro_torch.configs.minitron_8b import CONFIG as _minitron
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.gemma_7b import CONFIG as _gemma
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.gpt_family import GPT_FAMILY

ASSIGNED: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _minitron,
        _qwen3,
        _qwen25,
        _gemma,
        _seamless,
        _chameleon,
        _jamba,
        _mixtral,
        _llama4,
        _mamba2,
    ]
}

REGISTRY: dict[str, ModelConfig] = {**ASSIGNED, **GPT_FAMILY}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def shape_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Whether (arch, shape) is a live dry-run cell, else the skip reason."""
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch; long_500k needs sub-quadratic attention (see DESIGN.md)"
    return True, ""


__all__ = [
    "ModelConfig",
    "ParallelConfig",
    "ShapeConfig",
    "TrainConfig",
    "SHAPES",
    "ASSIGNED",
    "REGISTRY",
    "GPT_FAMILY",
    "get_config",
    "shape_applicable",
]
