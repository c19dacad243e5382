"""Per-group asymmetric uniform quantization (paper §3.1, eqs. 1-3).

Weights W[out, in] are grouped along the *input* (last) dimension in
contiguous groups of ``group_size`` (the paper's "1xN" mode). Each group gets
its own (scale, zero). Quantized codes live in [0, 2^bits - 1].

  * ``quantize`` / ``dequantize``     -- integer codes (storage / serving)
  * ``pack_int4`` / ``unpack_int4``   -- two codes per uint8 byte

``torch.round`` rounds half to even, as the reference's rounding does, so
both packages produce identical codes from identical weights.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 4
    group_size: int = 16
    min_scale: float = 1e-8

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1


def _group(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """[..., K] -> [..., K/G, G]."""
    if w.shape[-1] % group_size != 0:
        raise ValueError(
            f"last dim {w.shape[-1]} not divisible by group_size {group_size}")
    return w.reshape(*w.shape[:-1], w.shape[-1] // group_size, group_size)


def _ungroup(w: torch.Tensor) -> torch.Tensor:
    """[..., K/G, G] -> [..., K]."""
    return w.reshape(*w.shape[:-2], w.shape[-2] * w.shape[-1])


def group_minmax_params(w: torch.Tensor, cfg: QuantConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale/zero from per-group min/max (eq. 1). Returns (scale, zero),
    each shaped [..., K/G]."""
    g = _group(w.float(), cfg.group_size)
    wmax = g.amax(dim=-1)
    wmin = g.amin(dim=-1)
    scale = torch.clamp_min((wmax - wmin) / cfg.levels, cfg.min_scale)
    zero = torch.round(-wmin / scale)
    return scale, zero


def quantize(w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
             cfg: QuantConfig) -> torch.Tensor:
    """eq. 2: codes in [0, 2^bits - 1], shaped like w, dtype uint8."""
    g = _group(w.float(), cfg.group_size)
    q = torch.clamp(torch.round(g / scale[..., None]) + zero[..., None],
                    0, cfg.levels)
    return _ungroup(q).to(torch.uint8)


def dequantize(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
               cfg: QuantConfig, dtype=torch.float32) -> torch.Tensor:
    """eq. 3: (q - z) * s."""
    g = _group(q.float(), cfg.group_size)
    w = (g - zero[..., None]) * scale[..., None]
    return _ungroup(w).to(dtype)


# int4 <-> uint8 nibble packing: element 2i in the low nibble, 2i+1 in the
# high nibble (the reference's byte layout, which the CUDA kernel reads).

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """uint8 codes in [0,15], last dim even -> packed uint8, last dim K/2."""
    if q.shape[-1] % 2 != 0:
        raise ValueError("last dim must be even to pack nibbles")
    lo = q[..., 0::2].to(torch.uint8)
    hi = q[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """packed uint8 -> uint8 codes, last dim doubled."""
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)
