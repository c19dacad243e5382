"""GQS layer (paper §3.2): the drop-in replacement for Linear.

A linear layer's parameters take one of several *representations*; the
model code calls :func:`apply_linear`, which dispatches on the leaves
present:

    fp          {"w": [N,K] (, "b")}
    gqsa        {"bsr": BSRMatrix}                                  quant+sparse
    w4          {"qw" packed u8 [N,K/2], "scale","zero" [N,K/G]}   dense quant
    fake_quant  {"w", "gmask", ...}         (not yet ported)

The routed experts of an MoE layer stack these per expert ([E, ...]
leaves) and go through :func:`apply_linear_experts`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.pruning import PruneConfig
from repro_torch.core.quant import (QuantConfig, group_minmax_params,
                                    pack_int4, quantize)
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

    ``plain`` sends packed layers through their kernel's plain PyTorch
    version even on the card (kernel-vs-plain checks only)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "bsr" in p:
        # the kernel returns f32; the layer's output is the activation dtype
        y = kops.gqsa_gemv(x2, p["bsr"], plain=plain).to(x.dtype)
    elif "qw" in p:
        g = x2.shape[-1] // p["scale"].shape[-1]
        y = kops.w4_matmul(x2, p["qw"], p["scale"], p["zero"],
                           group_size=g, plain=plain).to(x.dtype)
    elif "gmask" in p or "q" in p:
        raise NotImplementedError(
            "fake-quant layers are not yet ported (ROADMAP A.6)")
    else:
        # params may be stored f32; compute in the activation dtype
        y = x2 @ p["w"].to(x.dtype).T
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y.reshape(*lead, -1)


def apply_linear_experts(p: Dict, x: torch.Tensor,
                         rows: torch.Tensor = None, *,
                         plain: bool = False) -> torch.Tensor:
    """The expert-stacked linear of an MoE layer: x [E, C, K] -> [E, C, N]
    in x's dtype, expert e's weights on row e of x (the reference's
    ``vmap`` of :func:`apply_linear` over the stacked experts).

    ``{"bsr"}`` (stacked [E, N, M] leaves) and dense W4 ``{"qw",
    "scale", "zero"}`` ([E, N, K/2] and [E, N, K/G]) go through their
    kernel's expert axis, ``rows`` [E] telling it how many leading rows of
    each expert hold tokens (the others come out as zeros); ``{"w"}``
    [E, N, K] is one batched product in x's dtype (the reference's FP
    path), where the empty rows, zeros in x, give zeros too."""
    if "bsr" in p:
        return kops.gqsa_gemv_experts(x, p["bsr"], rows,
                                      plain=plain).to(x.dtype)
    if "qw" in p:
        g = x.shape[-1] // p["scale"].shape[-1]
        return kops.w4_matmul_experts(x, p["qw"], p["scale"], p["zero"],
                                      rows, group_size=g,
                                      plain=plain).to(x.dtype)
    if "gmask" in p or "q" in p:
        raise NotImplementedError(
            "fake-quant layers are not yet ported (ROADMAP A.6)")
    return torch.bmm(x, p["w"].to(x.dtype).transpose(1, 2))


def pack_w4(w: torch.Tensor, qcfg: QuantConfig) -> Dict:
    """FP weight -> dense W<=4 serving params (quantization-only baseline).
    Nibble packing only holds codes < 16; wider bit-widths use the
    fake-quant (dense FP) representation instead."""
    if qcfg.bits > 4:
        raise ValueError("pack_w4 packs two codes per byte: bits must be "
                         "<= 4 (use fake_quant for W8)")
    s, z = group_minmax_params(w, qcfg)
    q = quantize(w, s, z, qcfg)
    return {"qw": pack_int4(q), "scale": s, "zero": z}
