"""Unified model / run configuration schema for the architecture zoo."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# dtype names of the configs -> torch dtypes
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int            # routed experts
    top_k: int
    n_shared: int = 0         # always-on shared experts
    d_expert: int = 0         # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128          # SSD chunk length
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | mla_moe | vlm | encdec | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    # architecture knobs
    mlp_type: str = "swiglu"          # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # hybrid (zamba2): shared attention block applied every k SSM layers
    shared_attn_every: int = 0
    # enc-dec (seamless): encoder depth (decoder = n_layers), stub frames
    enc_layers: int = 0
    n_frames: int = 960
    # vlm (llava): patch-embedding stub length
    n_patches: int = 0
    # numerics / execution
    kv_cache_dtype: str = "bf16"      # "int8": quantized decode KV cache
    analysis_unroll: bool = False     # unroll inner scans (cost analysis)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    attn_block_q: int = 512
    attn_block_k: int = 512
    # distribution
    fsdp: bool = False                # shard params over the data axis too
    grad_compress: bool = False       # int8 error-feedback DP all-reduce
    # which shapes are supported (long_500k only for sub-quadratic mixers)
    supports_long_context: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self):
        return _DTYPES[self.dtype]

    @property
    def params_dtype(self):
        return _DTYPES[self.param_dtype]

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline
        MODEL_FLOPS."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "hybrid"):
            hd = self.hd
            qkv = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads
            o = hd * self.n_heads * d
            attn = qkv + o
        if self.family in ("dense", "vlm"):
            mlp = (3 if self.mlp_type == "swiglu" else 2) * d * self.d_ff
            per_layer = attn + mlp
        elif self.family == "moe":
            moe = self.moe
            expert = 3 * d * moe.d_expert
            per_layer = attn + (moe.n_experts + moe.n_shared) * expert \
                + d * moe.n_experts
        elif self.family == "mla_moe":
            m, moe = self.mla, self.moe
            h = self.n_heads
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * h * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_dim)
                    + h * m.v_dim * d)
            expert = 3 * d * moe.d_expert
            per_layer = attn + (moe.n_experts + moe.n_shared) * expert \
                + d * moe.n_experts
        elif self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            per_layer = (d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                         + d_in * d)
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            ssm_l = (d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                     + d_in * d)
            shared = attn + 3 * d * self.d_ff
            return emb + self.n_layers * ssm_l + shared
        elif self.family == "encdec":
            hd = self.hd
            attn = 2 * d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads
            mlp = 2 * d * self.d_ff
            dec_layer = 2 * attn + mlp      # self + cross attention
            enc_layer = attn + mlp
            return emb + self.enc_layers * enc_layer + self.n_layers * dec_layer
        return emb + self.n_layers * per_layer

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        expert = 3 * self.d_model * self.moe.d_expert
        inactive = (self.moe.n_experts - self.moe.top_k) * expert
        return full - self.n_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""
    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
