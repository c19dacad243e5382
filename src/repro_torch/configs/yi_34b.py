"""yi-34b [arXiv:2403.04652]: llama-arch GQA dense. FSDP on."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab=64000,
        rope_theta=5e6, fsdp=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        dtype="float32", attn_block_q=32, attn_block_k=32,
    )
