"""Whole-model compression: walk a parameter tree and replace every
eligible linear's {"w"} with a packed serving representation, packed GQSA
({"bsr"}) or the dense-W4 baseline ({"qw", "scale", "zero"}).

Eligible = the decode-path GEMV weights (attention projections and MLP).
Embeddings, lm_head and norms stay FP, as in the reference.

Stacked [L, N, K] leaves are packed one [N, K] slice at a time into
preallocated stacked leaves, on the weights' device: at full llama2-7b
width a slice is at most 180 MB of f32, so packing never holds more than
one layer's temporaries (:class:`StackedPacker` is also what
``models/transformer.py:init_params`` feeds layer by layer, so the full
f32 model never exists at all).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Union

import torch

from repro_torch.core.bsr import BSRMatrix, pack_dense
from repro_torch.core.gqs_layer import GQSAConfig, pack_w4
from repro_torch.core.pruning import PruneConfig, group_mask
from repro_torch.core.quant import QuantConfig
from repro_torch.core.saliency import group_saliency, magnitude_saliency

COMPRESSIBLE = re.compile(
    r"(wq|wk|wv|wo|wg|wu|wd|w_qa|w_qb|w_kva|in_proj|out_proj)$")
EXCLUDED = re.compile(r"(router|shared_?$)")  # routers stay FP
BSR_LEAVES = ("idx", "vals", "scale", "zero")

# a compression: GQSAConfig -> packed GQSA, QuantConfig -> dense W4
Compression = Union[GQSAConfig, QuantConfig]


def is_compressible(pstr: str) -> bool:
    return bool(COMPRESSIBLE.search(pstr)) and not EXCLUDED.search(pstr)


def pack_linear(w: torch.Tensor, gqsa: GQSAConfig) -> BSRMatrix:
    """One-shot (no calibration stats) FP [N, K] -> packed GQSA: magnitude
    saliency, row-balanced group mask, per-group INT4."""
    gsal = group_saliency(magnitude_saliency(w), gqsa.prune.group_size)
    return pack_dense(w, group_mask(gsal, gqsa.prune), gqsa.quant)


def slice_packer(compress: Compression) -> Callable[[torch.Tensor], Dict]:
    """The per-slice packing function of a compression: FP [N, K] -> the
    layer's serving node ({"bsr"} or {"qw", "scale", "zero"})."""
    if isinstance(compress, GQSAConfig):
        return lambda w: {"bsr": pack_linear(w, compress)}
    if isinstance(compress, QuantConfig):
        return lambda w: pack_w4(w, compress)
    raise TypeError(f"unknown compression {compress!r}: a GQSAConfig "
                    f"(GQSA) or a QuantConfig (dense W4)")


def _tensors(node) -> List[torch.Tensor]:
    """The tensor leaves of a serving node, in a fixed order."""
    if isinstance(node, BSRMatrix):
        return [getattr(node, f) for f in BSR_LEAVES]
    return [t for k in sorted(node) for t in _tensors(node[k])] \
        if isinstance(node, dict) else [node]


def _map(node, fn):
    """The node with ``fn`` applied to each tensor leaf."""
    if isinstance(node, BSRMatrix):
        return dataclasses.replace(
            node, **{f: fn(getattr(node, f)) for f in BSR_LEAVES})
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node)


class StackedPacker:
    """Packs the [N, K] slices of one stacked linear as they arrive, with
    ``pack`` (one of :func:`slice_packer`'s functions), and writes each
    into preallocated stacked leaves ([count, ...])."""

    def __init__(self, count: int, pack: Callable[[torch.Tensor], Dict]):
        self.count = count
        self.pack = pack
        self.out: Optional[Dict] = None

    def put(self, i: int, w: torch.Tensor) -> None:
        node = self.pack(w)
        if self.out is None:
            self.out = _map(node, lambda t: torch.empty(
                (self.count,) + tuple(t.shape), dtype=t.dtype,
                device=t.device))
        for dst, src in zip(_tensors(self.out), _tensors(node)):
            if src.shape != dst.shape[1:]:
                raise ValueError("stacked slices must keep the same shapes "
                                 "(row-balanced packing)")
            dst[i].copy_(src)

    def result(self, lead=()) -> Dict:
        if not lead:
            return _map(self.out, lambda t: t[0]) if self.count == 1 \
                else self.out
        return _map(self.out, lambda t: t.reshape(tuple(lead)
                                                  + tuple(t.shape[1:])))


def _pack_stacked(w: torch.Tensor, compress: Compression) -> Dict:
    """w: [..., N, K] -> the serving node with the leading dims on each
    leaf."""
    lead = tuple(w.shape[:-2])
    n, k = w.shape[-2:]
    flat = w.reshape(-1, n, k)
    packer = StackedPacker(flat.shape[0], slice_packer(compress))
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
    return _walk(params, "", lambda node: _pack_stacked(node["w"], gqsa))


def compress_params_w4(params: Dict, cfg, qcfg: QuantConfig) -> Dict:
    """Quantization-only baseline (dense W4, no pruning)."""
    return _walk(params, "", lambda node: _pack_stacked(node["w"], qcfg))


# ---------------------------------------------------------------------------
# Draft profiles (self-speculative decoding): one FP checkpoint yields both
# the deployed target compression and a more aggressive draft compression.
# The verify step keeps the served distribution exactly the target's, so a
# profile only trades acceptance rate against draft cost.
# ---------------------------------------------------------------------------

DRAFT_PROFILES: Dict[str, Dict] = {
    # dense 4-bit (no pruning): near-target quality, highest acceptance
    "w4": dict(bits=4, sparsity=0.0),
    # the paper's deployed setting: as a draft it accepts ~everything
    "w4s50": dict(bits=4, sparsity=0.5),
    # settings too lossy to serve, which a drafter may be
    "w4s75": dict(bits=4, sparsity=0.75),
    "w2s50": dict(bits=2, sparsity=0.5),
    "w2s75": dict(bits=2, sparsity=0.75),
    # depth-pruned (the first 12.5% / 25% / 50% of layers; the shallow
    # exit shares the target's final norm and unembedding)
    "w4l12": dict(bits=4, sparsity=0.0, depth=0.125),
    "w4l25": dict(bits=4, sparsity=0.0, depth=0.25),
    "w4l50": dict(bits=4, sparsity=0.0, depth=0.5),
    "w4s50l50": dict(bits=4, sparsity=0.5, depth=0.5),
}


def draft_layers(cfg, profile: str) -> int:
    """Drafter depth of a profile (>= 1; the full depth without one)."""
    try:
        spec = DRAFT_PROFILES[profile]
    except KeyError:
        raise ValueError(f"unknown draft profile {profile!r}; "
                         f"known: {sorted(DRAFT_PROFILES)}") from None
    return max(1, int(round(cfg.n_layers * spec.get("depth", 1.0))))


def draft_compression(profile: str, group_size: int = 16) -> Compression:
    """The packing of a profile: dense W<bits> at sparsity 0, else GQSA
    at the profile's (bits, sparsity)."""
    spec = DRAFT_PROFILES[profile]
    quant = QuantConfig(bits=spec["bits"], group_size=group_size)
    if spec["sparsity"] <= 0.0:
        return quant
    return GQSAConfig(quant=quant, prune=PruneConfig(
        sparsity=spec["sparsity"], group_size=group_size))


def compress_draft(params: Dict, cfg, profile: str = "w4s75",
                   group_size: int = 16) -> Dict:
    """FP param tree -> the draft-profile parameter set of the same
    checkpoint: depth profiles keep the leading ``draft_layers`` layer
    slices (embed, final norm and lm_head stay shared), then pack with
    :func:`draft_compression`. A depth-pruned draft runs at
    ``draft_layers(cfg, profile)`` layers (``EngineConfig.
    spec_draft_layers``). ``models/transformer.py:init_params`` packs the
    same draft from the weights as they are drawn (``draft=``)."""
    dl = draft_layers(cfg, profile)
    if dl < cfg.n_layers:
        params = dict(params, layers=_map(params["layers"],
                                          lambda t: t[:dl]))
    return _walk(params, "", lambda node: _pack_stacked(
        node["w"], draft_compression(profile, group_size)))
