"""qwen3-14b [hf:Qwen/Qwen3]: GQA + qk_norm."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936,
        head_dim=128, qk_norm=True, rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        head_dim=16, qk_norm=True, dtype="float32",
        attn_block_q=32, attn_block_k=32,
    )
