"""deepseek-v2-236b [arXiv:2405.04434]: MLA (kv_lora=512) + 2 shared +
160 routed top-6 experts; every layer is MLA + MoE (the published
``first_k_dense_replace=1`` leading dense layer is not modelled)."""
from repro_torch.configs.base import MLACfg, ModelConfig, MoECfg


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="mla_moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=1536, vocab=102400,
        moe=MoECfg(n_experts=160, top_k=6, n_shared=2, d_expert=1536),
        mla=MLACfg(kv_lora_rank=512, q_lora_rank=1536,
                   qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
        fsdp=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-reduced", family="mla_moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=256,
        moe=MoECfg(n_experts=8, top_k=2, n_shared=2, d_expert=96),
        mla=MLACfg(kv_lora_rank=32, q_lora_rank=48,
                   qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
        dtype="float32", attn_block_q=32, attn_block_k=32,
    )
