"""Whole-model GQSA compression: walk a parameter tree and replace every
eligible linear's {"w"} with the packed-BSR serving representation.

Eligible = the decode-path GEMV weights (attention projections and MLP).
Embeddings, lm_head and norms stay FP, as in the reference.

Stacked [L, N, K] leaves are packed one [N, K] slice at a time into
preallocated stacked BSR leaves, on the weights' device: at full llama2-7b
width a slice is at most 180 MB of f32, so packing never holds more than
one layer's temporaries (:class:`StackedPacker` is also what
``models/transformer.py:init_params`` feeds layer by layer, so the full
f32 model never exists at all).
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from repro_torch.core.bsr import BSRMatrix, pack_dense
from repro_torch.core.gqs_layer import GQSAConfig
from repro_torch.core.pruning import group_mask
from repro_torch.core.saliency import group_saliency, magnitude_saliency

COMPRESSIBLE = re.compile(
    r"(wq|wk|wv|wo|wg|wu|wd|w_qa|w_qb|w_kva|in_proj|out_proj)$")
EXCLUDED = re.compile(r"(router|shared_?$)")  # routers stay FP


def is_compressible(pstr: str) -> bool:
    return bool(COMPRESSIBLE.search(pstr)) and not EXCLUDED.search(pstr)


def pack_linear(w: torch.Tensor, gqsa: GQSAConfig) -> BSRMatrix:
    """One-shot (no calibration stats) FP [N, K] -> packed GQSA: magnitude
    saliency, row-balanced group mask, per-group INT4."""
    gsal = group_saliency(magnitude_saliency(w), gqsa.prune.group_size)
    return pack_dense(w, group_mask(gsal, gqsa.prune), gqsa.quant)


class StackedPacker:
    """Packs the [N, K] slices of one stacked linear as they arrive and
    writes each into preallocated stacked leaves ([count, N, M], ...)."""

    def __init__(self, count: int, gqsa: GQSAConfig):
        self.count = count
        self.gqsa = gqsa
        self.out: Optional[BSRMatrix] = None

    def put(self, i: int, w: torch.Tensor) -> None:
        b = pack_linear(w, self.gqsa)
        if self.out is None:
            def stacked(t):
                return torch.empty((self.count,) + tuple(t.shape),
                                   dtype=t.dtype, device=t.device)
            self.out = BSRMatrix(idx=stacked(b.idx), vals=stacked(b.vals),
                                 scale=stacked(b.scale),
                                 zero=stacked(b.zero), shape=b.shape,
                                 group_size=b.group_size, bits=b.bits)
        if b.idx.shape != self.out.idx.shape[1:]:
            raise ValueError("stacked slices must keep the same groups per "
                             "row (row-balanced packing)")
        for name in ("idx", "vals", "scale", "zero"):
            getattr(self.out, name)[i].copy_(getattr(b, name))

    def result(self, lead=()) -> BSRMatrix:
        o = self.out
        if not lead:
            return o.layer(0) if self.count == 1 else o

        def shaped(t):
            return t.reshape(tuple(lead) + tuple(t.shape[1:]))
        return BSRMatrix(idx=shaped(o.idx), vals=shaped(o.vals),
                         scale=shaped(o.scale), zero=shaped(o.zero),
                         shape=o.shape, group_size=o.group_size, bits=o.bits)


def _pack_stacked(w: torch.Tensor, gqsa: GQSAConfig) -> BSRMatrix:
    """w: [..., N, K] -> BSRMatrix with the leading dims on each leaf."""
    lead = tuple(w.shape[:-2])
    n, k = w.shape[-2:]
    flat = w.reshape(-1, n, k)
    packer = StackedPacker(flat.shape[0], gqsa)
    for i in range(flat.shape[0]):
        packer.put(i, flat[i])
    return packer.result(lead)


def _walk(node, path, fn):
    """Replace {"w": leaf} dicts at compressible paths via fn(leaf)."""
    if isinstance(node, dict):
        if "w" in node and len(node) <= 2 and is_compressible(path):
            return fn(node)
        return {k: _walk(v, f"{path}.{k}" if path else k, fn)
                for k, v in node.items()}
    return node


def compress_params(params: Dict, cfg, gqsa: GQSAConfig) -> Dict:
    """FP param tree -> serving tree with packed GQS layers (magnitude
    saliency: the reference's behaviour without calibration stats)."""
    return _walk(params, "",
                 lambda node: {"bsr": _pack_stacked(node["w"], gqsa)})
