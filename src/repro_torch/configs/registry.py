"""Architecture registry: the configs the port can serve so far, and the
input specs of every (arch x shape) cell."""
from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCfg

# in the reference's order, the paper's own benchmark model (the extra)
# last; not yet ported: the vlm family's llava_next_mistral_7b (ROADMAP
# A.7.3) and the families without a paged cache, seamless_m4t_large_v2,
# zamba2_7b and mamba2_130m (A.8)
ARCH_IDS = [
    "deepseek_moe_16b",
    "deepseek_v2_236b",
    "yi_34b",
    "starcoder2_3b",
    "qwen3_14b",
    "mistral_nemo_12b",
    "llama2_7b",
]

# assignment ids use dashes
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    name = _ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported (ported: {ARCH_IDS}; "
            f"ROADMAP A.7.3, A.8)")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.reduced() if reduced else mod.full()


def list_archs(include_extra: bool = False) -> List[str]:
    return ARCH_IDS if include_extra else ARCH_IDS[:-1]


def list_draft_profiles() -> List[str]:
    """Draft compression profiles for speculative decoding (the serve
    CLI's --draft-profile choices)."""
    from repro_torch.core.model_compress import DRAFT_PROFILES
    return sorted(DRAFT_PROFILES)


def supported_shapes(cfg: ModelConfig) -> List[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return out


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict:
    """Stand-ins for a forward/train call's inputs: tensors on the
    ``meta`` device (shape and dtype, no storage).

    For decode shapes these are the *per-step* token inputs; the cache
    specs come from ``init_cache`` on the meta device."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = cfg.compute_dtype

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((b, 1), i32)}

    batch: Dict = {}
    if cfg.family == "vlm":
        s_text = s - cfg.n_patches
        batch["tokens"] = spec((b, s_text), i32)
        batch["patch_embeds"] = spec((b, cfg.n_patches, cfg.d_model), dt)
        if shape.kind == "train":
            batch["labels"] = spec((b, s_text), i32)
        return batch
    if cfg.family == "encdec":
        batch["tokens"] = spec((b, s), i32)
        batch["frames"] = spec((b, cfg.n_frames, cfg.d_model), dt)
        if shape.kind == "train":
            batch["labels"] = spec((b, s), i32)
        return batch
    batch["tokens"] = spec((b, s), i32)
    if shape.kind == "train":
        batch["labels"] = spec((b, s), i32)
    return batch

