"""Port configs: the paper's experiment configurations (``sns_paper``) and
the LM stack's architecture registry, ``--arch <id>`` → (FULL, SMOKE)
ModelConfigs (shapes only; weights are drawn from a seed)."""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from repro_torch.configs import (arctic_480b, deepseek_coder_33b,
                                 internvl2_26b, jamba_v0_1_52b, llama3_2_3b,
                                 mamba2_130m, qwen1_5_110b,
                                 qwen3_moe_235b_a22b, seamless_m4t_large_v2,
                                 tinyllama_1_1b)

_MODULES = {
    "internvl2-26b": internvl2_26b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "llama3.2-3b": llama3_2_3b,
    "qwen1.5-110b": qwen1_5_110b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "mamba2-130m": mamba2_130m,
    "arctic-480b": arctic_480b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = _MODULES[arch_id]
    return mod.SMOKE if smoke else mod.FULL


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}
