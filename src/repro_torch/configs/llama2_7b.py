"""llama-2-7b [arXiv:2307.09288]: the paper's own benchmark model (GQSA
Tables 1-4). Extra config, not one of the 10 assigned cells."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab=32000,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        dtype="float32", attn_block_q=32, attn_block_k=32,
    )
