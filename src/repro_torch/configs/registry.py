"""Architecture registry: the configs the port can serve so far."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

# the paper's own benchmark model, the MoE family's and the MLA + MoE
# family's one config each; not yet ported: the other dense configs
# (yi_34b, starcoder2_3b, qwen3_14b, mistral_nemo_12b: ROADMAP A.3), the
# vlm family's llava_next_mistral_7b (A.7.3) and the families without a
# paged cache, zamba2_7b, mamba2_130m and seamless_m4t_large_v2 (A.8)
ARCH_IDS = ["llama2_7b", "deepseek_moe_16b", "deepseek_v2_236b"]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    name = _ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported (ported: {ARCH_IDS}; "
            f"ROADMAP A.3, A.7.3, A.8)")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.reduced() if reduced else mod.full()


def list_draft_profiles() -> List[str]:
    """Draft compression profiles for speculative decoding (the serve
    CLI's --draft-profile choices)."""
    from repro_torch.core.model_compress import DRAFT_PROFILES
    return sorted(DRAFT_PROFILES)
