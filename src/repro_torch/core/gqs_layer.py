"""GQS layer (paper §3.2): the drop-in replacement for Linear.

A linear layer's parameters take one of several *representations*; the
model code calls :func:`apply_linear`, which dispatches on the leaves
present:

    fp          {"w": [N,K] (, "b")}
    gqsa        {"bsr": BSRMatrix}          quantized + group-sparse
    w4          {"qw", "scale", "zero"}     (not yet ported)
    fake_quant  {"w", "gmask", ...}         (not yet ported)
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.pruning import PruneConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class GQSAConfig:
    """End-to-end compression configuration (paper W4 S{20..50} G16)."""
    quant: QuantConfig = QuantConfig(bits=4, group_size=16)
    prune: PruneConfig = PruneConfig(sparsity=0.5, group_size=16,
                                     row_balanced=True)

    def __post_init__(self):
        if self.quant.group_size != self.prune.group_size:
            raise ValueError("quant and prune group sizes must match: the "
                             "group is both the quant and the prune unit")


def apply_linear(p: Dict, x: torch.Tensor, *,
                 plain: bool = False) -> torch.Tensor:
    """x: [..., K] -> [..., N]; dispatch on the parameter representation.

    ``plain`` sends packed layers through the GEMV's plain PyTorch version
    even on the card (kernel-vs-plain checks only)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "bsr" in p:
        # the kernel returns f32; the layer's output is the activation dtype
        y = kops.gqsa_gemv(x2, p["bsr"], plain=plain).to(x.dtype)
    elif "qw" in p:
        raise NotImplementedError(
            "dense W4 layers are not yet ported (ROADMAP B.3)")
    elif "gmask" in p or "q" in p:
        raise NotImplementedError(
            "fake-quant layers are not yet ported (ROADMAP A.6)")
    else:
        # params may be stored f32; compute in the activation dtype
        y = x2 @ p["w"].to(x.dtype).T
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y.reshape(*lead, -1)
