"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407]: 128k-context GQA
dense (head_dim 128 != d_model/n_heads)."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=131072,
        head_dim=128, rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        head_dim=16, dtype="float32", attn_block_q=32, attn_block_k=32,
    )
