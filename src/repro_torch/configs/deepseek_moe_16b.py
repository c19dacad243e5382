"""deepseek-moe-16b [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64
routed top-6 experts behind GQA attention (family ``moe``)."""
from repro_torch.configs.base import ModelConfig, MoECfg


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=102400,
        moe=MoECfg(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=256,
        moe=MoECfg(n_experts=8, top_k=2, n_shared=2, d_expert=96),
        dtype="float32", attn_block_q=32, attn_block_k=32,
    )
