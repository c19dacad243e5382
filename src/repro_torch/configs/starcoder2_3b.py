"""starcoder2-3b [arXiv:2402.19173]: GQA (kv=2), RoPE, non-gated GELU MLP."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab=49152,
        mlp_type="gelu", rope_theta=1e5,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        mlp_type="gelu", dtype="float32",
        attn_block_q=32, attn_block_k=32,
    )
