"""Model configurations (port of the reference package's configs)."""
from repro_torch.configs.base import ModelConfig, MoECfg, MLACfg, SSMCfg, SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
