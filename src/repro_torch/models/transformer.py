"""Decoder-only LM, dense, MoE (``moe``) and MLA + MoE (``mla_moe``)
families: init, the full-sequence forward, batched prefill into the paged
pool, and the decode step on the paged pool or on the contiguous cache.

Parameters keep the reference's tree layout: nested dicts whose per-layer
leaves are stacked [L, ...] (``params["layers"]["attn"]["wq"]["w"]`` is
[L, N, K]; a packed layer holds ``{"bsr": BSRMatrix}`` or dense W4
``{"qw", "scale", "zero"}`` with stacked leaves; the routed experts of
``params["layers"]["moe"]["experts"]`` are stacked [L, E, ...]). The layer
loop is a Python loop over slices of those leaves. ``mla_moe`` pages one
latent pool (``{"lat_pages"}``), the other families a K and a V pool.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.bsr import BSRMatrix
from repro_torch.core.gqs_layer import apply_linear
from repro_torch.core.model_compress import (Compression, StackedPacker,
                                             draft_compression, draft_layers,
                                             slice_packer)
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_weights(cfg) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                        float, str]]:
    """``(path, per-layer shape, init scale, kind)`` of every drawn
    per-layer weight, in draw order (the reference's layout and scales).
    kind: "linear" ({"w"}, packed under a compression), "experts" (an
    [E, N, K] stack of linears, packed one expert at a time), "fp" (a
    linear that stays FP: the router), "raw" (a bare tensor: MLA's
    w_uk / w_uv)."""
    d, h = cfg.d_model, cfg.n_heads

    def lin(path, n, k, kind="linear"):
        return (path, (n, k), 1.0 / math.sqrt(k), kind)

    if cfg.family == "mla_moe":
        m = cfg.mla
        r = m.kv_lora_rank
        out = [lin(("attn", "w_qa"), m.q_lora_rank, d),
               lin(("attn", "w_qb"), h * (m.qk_nope_dim + m.qk_rope_dim),
                   m.q_lora_rank),
               lin(("attn", "w_kva"), r + m.qk_rope_dim, d),
               (("attn", "w_uk"), (h, m.qk_nope_dim, r), 1.0 / math.sqrt(r),
                "raw"),
               (("attn", "w_uv"), (h, m.v_dim, r), 1.0 / math.sqrt(r),
                "raw"),
               lin(("attn", "wo"), d, h * m.v_dim)]
    else:
        khn, hd = cfg.n_kv_heads, cfg.hd
        out = [lin(("attn", "wq"), h * hd, d),
               lin(("attn", "wk"), khn * hd, d),
               lin(("attn", "wv"), khn * hd, d),
               lin(("attn", "wo"), d, h * hd)]
    if cfg.moe is None:
        if cfg.mlp_type == "swiglu":
            out.append(lin(("mlp", "wg"), cfg.d_ff, d))
        return out + [lin(("mlp", "wu"), cfg.d_ff, d),
                      lin(("mlp", "wd"), d, cfg.d_ff)]
    moe = cfg.moe
    de, ds = moe.d_expert, moe.n_shared * moe.d_expert
    out.append(lin(("moe", "router"), moe.n_experts, d, "fp"))
    # every expert stack, wd included, at 1/sqrt(d_model)
    out += [(("moe", "experts", name), (moe.n_experts,) + nk,
             1.0 / math.sqrt(d), "experts")
            for name, nk in (("wg", (de, d)), ("wu", (de, d)),
                             ("wd", (d, de)))]
    if moe.n_shared:
        out += [lin(("moe", "shared", "wg"), ds, d),
                lin(("moe", "shared", "wu"), ds, d),
                lin(("moe", "shared", "wd"), d, ds)]
    return out


def _layer_norms(cfg) -> Dict[Tuple[str, ...], int]:
    """Per-layer norm weights (ones) beside ln1 / ln2: MLA's latent norms,
    or ``qk_norm``'s per-head norms of q and k (the reference's
    ``attn_init``)."""
    if cfg.family == "mla_moe":
        return {("attn", "q_norm"): cfg.mla.q_lora_rank,
                ("attn", "kv_norm"): cfg.mla.kv_lora_rank}
    if cfg.qk_norm:
        return {("attn", "q_norm"): cfg.hd, ("attn", "k_norm"): cfg.hd}
    return {}


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def init_params(seed: int, cfg, device=None,
                compress: Optional[Compression] = None) -> Dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on the
    device: other numbers than the reference's ``PRNGKey`` init, whose
    trees the tests carry over through ``repro_torch.bridge`` instead).

    Linear weights are N(0, 1/K) like the reference's (routed experts
    N(0, 1/d_model), MLA's w_uk / w_uv N(0, 1/kv_lora_rank)). With
    ``compress`` (a ``GQSAConfig``: packed GQSA; a ``QuantConfig``: dense
    W4) each layer's linears are packed as soon as they are drawn, one
    layer (and one routed expert) at a time, so the full f32 model (26 GB
    at llama2-7b width; one f32 expert stack of DeepSeek-V2 is 5 GB) never
    exists; the result equals ``compress_params(init_params(seed, cfg,
    device), cfg, gqsa)`` or ``compress_params_w4(..., qcfg)``."""
    return _draw(seed, cfg, device, [(compress, cfg.n_layers)])[0]


def init_params_and_draft(seed: int, cfg, profile: str, device=None,
                          compress: Optional[Compression] = None,
                          group_size: int = 16) -> Tuple[Dict, Dict]:
    """``(params, draft_params)``: :func:`init_params` and the draft
    profile ``profile`` of the same weights, packed from each slice as it
    is drawn (``compress_draft(init_params(seed, cfg, device), cfg,
    profile, group_size)`` without the f32 model). The draft keeps the
    first ``draft_layers(cfg, profile)`` layers and shares ``embed``,
    ``final_norm`` and ``lm_head`` with the target (drawing them again
    would give another ``lm_head``: it is drawn after every layer)."""
    params, drafts = init_params_and_drafts(seed, cfg, (profile,), device,
                                            compress, group_size)
    return params, drafts[profile]


def init_params_and_drafts(seed: int, cfg, profiles, device=None,
                           compress: Optional[Compression] = None,
                           group_size: int = 16) -> Tuple[Dict, Dict]:
    """``(params, {profile: draft_params})``: :func:`init_params_and_draft`
    for several draft profiles from one draw of the weights (each packed
    from the slices as they are drawn)."""
    profiles = tuple(profiles)
    trees = _draw(seed, cfg, device, [(compress, cfg.n_layers)] + [
        (draft_compression(p, group_size), draft_layers(cfg, p))
        for p in profiles])
    return trees[0], dict(zip(profiles, trees[1:]))


def _draw(seed: int, cfg, device, targets) -> List[Dict]:
    """One draw of the weights, packed into one tree per ``(compression
    or None, layer count)`` of ``targets``; every tree holds the leading
    layers of the same draw and the same embedding and head tensors."""
    if cfg.family not in ("dense", "moe", "mla_moe") or cfg.tie_embeddings:
        raise NotImplementedError(
            f"init for family {cfg.family!r} (tie_embeddings="
            f"{cfg.tie_embeddings}) is not yet ported (ROADMAP A.7.3, A.8)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = cfg.params_dtype
    n_layers, d = cfg.n_layers, cfg.d_model

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=dev) * scale

    embed = normal((cfg.vocab, d), 0.02)
    weights = _layer_weights(cfg)
    packs = [slice_packer(c) if c is not None else None for c, _ in targets]

    def holder(pack, nl, shape, kind):
        """Where one target keeps a weight: a packer of its slices, or
        the f32 stack."""
        if pack and kind == "linear":
            return StackedPacker(nl, pack)
        if pack and kind == "experts":
            return StackedPacker(nl * shape[0], pack)
        return torch.empty((nl,) + shape, dtype=dt, device=dev)

    stacks = [{path: holder(pack, nl, shape, kind)
               for path, shape, _, kind in weights}
              for pack, (_, nl) in zip(packs, targets)]
    for i in range(n_layers):
        for path, shape, scale, kind in weights:
            # a routed expert stack is drawn one expert at a time
            parts = range(shape[0]) if kind == "experts" else [None]
            for e in parts:
                w = normal(shape if e is None else shape[1:], scale)
                for (_, nl), st in zip(targets, stacks):
                    if i >= nl:
                        continue
                    h = st[path]
                    if isinstance(h, StackedPacker):
                        h.put(i if e is None else i * shape[0] + e, w)
                    else:
                        (h[i] if e is None else h[i, e]).copy_(w)
                del w
    final_norm = torch.ones((d,), dtype=dt, device=dev)
    lm_head = {"w": normal((cfg.vocab, d), 0.02)}
    trees = []
    for (_, nl), st in zip(targets, stacks):
        layers = {"ln1": torch.ones((nl, d), dtype=dt, device=dev),
                  "ln2": torch.ones((nl, d), dtype=dt, device=dev)}
        for path, dim in _layer_norms(cfg).items():
            _set(layers, path, torch.ones((nl, dim), dtype=dt, device=dev))
        for path, shape, _, kind in weights:
            h = st[path]
            if isinstance(h, StackedPacker):
                node = h.result((nl,) if kind == "linear"
                                else (nl, shape[0]))
            else:
                node = h if kind == "raw" else {"w": h}
            _set(layers, path, node)
        trees.append({"embed": embed, "layers": layers,
                      "final_norm": final_norm, "lm_head": lm_head})
    return trees


def layer_params(tree, i: int):
    """Layer ``i``'s parameters: the entry of a per-layer sequence
    (:func:`split_layers`), or the slice of the stacked tree (views)."""
    if isinstance(tree, (list, tuple)):
        return tree[i]
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, BSRMatrix):
        return tree.layer(i)
    return tree[i]


def split_layers(params: Dict, cfg) -> Dict:
    """The same parameters with ``"layers"`` as a tuple of per-layer views,
    sliced once: a serving loop that keeps this form skips re-slicing every
    stacked leaf in every layer of every step. No data is copied."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return params
    return dict(params, layers=tuple(layer_params(layers, i)
                                     for i in range(cfg.n_layers)))


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params: Dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


def unembed(params: Dict, h: torch.Tensor, cfg) -> torch.Tensor:
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    # the lm_head product is a plain matmul (outside any kernel)
    return apply_linear(params["lm_head"], h)


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _mixer(lp: Dict, hn: torch.Tensor, cfg, plain: bool,
           aux: bool = False) -> Tuple[torch.Tensor,
                                       Optional[torch.Tensor]]:
    """The layer's feed-forward half: routed + shared experts, or the
    MLP; with the router's aux loss when ``aux`` and the layer has one
    (else None)."""
    if cfg.moe is not None:
        return MOE.moe_block(lp["moe"], hn, cfg, plain, aux)
    return L.mlp_block(lp["mlp"], hn, cfg.mlp_type, plain), None


def forward(params: Dict, tokens: torch.Tensor, cfg, plain: bool = False,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (logits [B, S, V] (``last_only``: [B, 1, V] at
    the last position), the router's aux loss summed over the layers and
    divided by their count: f32 [], 0 without routed experts). Causal
    attention over the whole sequence, no cache."""
    b, s = tokens.shape
    h = embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None, :].expand(b, s)
    rope = L.rope_table(positions, L.rope_dim(cfg), cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        hn = L.rmsnorm(h, lp["ln1"], cfg.norm_eps)
        if cfg.family == "mla_moe":
            h = h + MLA.mla_block(lp["attn"], hn, cfg, rope, plain)
        else:
            h = h + L.attention_block(lp["attn"], hn, positions, cfg, plain,
                                      rope)
        hn = L.rmsnorm(h, lp["ln2"], cfg.norm_eps)
        m, aux_l = _mixer(lp, hn, cfg, plain, aux=True)
        h = h + m
        if aux_l is not None:
            aux = aux + aux_l
    if last_only:
        h = h[:, -1:]
    return unembed(params, h, cfg), aux / cfg.n_layers


# ---------------------------------------------------------------------------
# contiguous cache (static batch)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype=None,
               device=None) -> Dict:
    """Contiguous decode cache, zeroed, leaves [L, B, S, ...]: K/V [L, B,
    S, KH, D] in ``dtype`` (default the compute dtype), or, with
    ``cfg.kv_cache_dtype == "int8"``, int8 codes beside f32 scales [L, B,
    S, KH]; ``mla_moe`` keeps its latent, ``{"c_kv": [L, B, S, R],
    "k_rope": [L, B, S, rope]}`` in ``dtype`` whatever
    ``kv_cache_dtype`` says, as in the reference. The decode step writes
    it in place."""
    dev = resolve_device(device)
    dt = dtype or cfg.compute_dtype
    lyr = cfg.n_layers
    if cfg.family == "mla_moe":
        # one layer's layout, on the meta device (nothing allocated)
        one = MLA.mla_cache_init(cfg, batch, max_seq, dt, "meta")
        return {k: torch.zeros((lyr,) + v.shape, dtype=dt, device=dev)
                for k, v in one.items()}
    shape = (lyr, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)}
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _decode_contiguous(params: Dict, cache: Dict, tokens: torch.Tensor,
                       pos: torch.Tensor, cfg, plain: bool) -> torch.Tensor:
    """The contiguous branch of :func:`decode_step`: logits [B, 1, V]."""
    b, t = tokens.shape
    if t != 1:
        raise ValueError(f"the contiguous cache decodes one token a step, "
                         f"got T={t}")
    max_seq = next(iter(cache.values())).shape[2]
    # rotations and cache rows are the same in every layer
    positions = torch.as_tensor(pos).reshape(-1, 1).expand(b, 1)
    rope = L.rope_table(positions, L.rope_dim(cfg), cfg.rope_theta)
    write = L.plan_cache_write(pos, b, max_seq)
    h = embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        hn = L.rmsnorm(h, lp["ln1"], cfg.norm_eps)
        if cfg.family == "mla_moe":
            h = h + MLA.mla_decode(lp["attn"], hn, layer_cache(cache, i),
                                   pos, cfg, rope, write, plain)
        else:
            h = h + L.attention_decode(lp["attn"], hn, layer_cache(cache, i),
                                       pos, cfg, plain, rope, write)
        hn = L.rmsnorm(h, lp["ln2"], cfg.norm_eps)
        h = h + _mixer(lp, hn, cfg, plain)[0]
    return unembed(params, h, cfg)


# ---------------------------------------------------------------------------
# paged KV pool, prefill, decode
# ---------------------------------------------------------------------------

def init_paged_cache(cfg, num_pages: int, page_size: int,
                     device=None) -> Dict:
    """Paged KV pool [L, P, ps, KH, D], zeroed: in the compute dtype, or,
    with ``cfg.kv_cache_dtype == "int8"``, int8 codes beside f32
    per-token x head scale pages [L, P, ps, KH]. ``mla_moe`` pages the
    latent instead: ``{"lat_pages": [L, P, ps, kv_lora_rank +
    qk_rope_dim]}`` in the compute dtype whatever ``kv_cache_dtype`` says,
    as in the reference. The steps below write it in place (the reference
    updates it functionally)."""
    dev = resolve_device(device)
    if cfg.family == "mla_moe":
        m = cfg.mla
        return {"lat_pages": torch.zeros(
            (cfg.n_layers, num_pages, page_size,
             m.kv_lora_rank + m.qk_rope_dim), dtype=cfg.compute_dtype,
            device=dev)}
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v_pages": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale_pages": torch.zeros(shape[:-1], dtype=torch.float32,
                                             device=dev),
                "v_scale_pages": torch.zeros(shape[:-1], dtype=torch.float32,
                                             device=dev)}
    dt = cfg.compute_dtype
    return {"k_pages": torch.zeros(shape, dtype=dt, device=dev),
            "v_pages": torch.zeros(shape, dtype=dt, device=dev)}


def layer_cache(cache: Dict, i: int) -> Dict:
    """Layer ``i``'s view of every pool (codes and, int8, scale pages)."""
    return {k: v[i] for k, v in cache.items()}


def pool_geometry(cache: Dict) -> Tuple[int, int]:
    """(num_pages, page_size) of a paged pool of either family."""
    num_pages, page_size = next(iter(cache.values())).shape[1:3]
    return num_pages, page_size


def prefill(params: Dict, cache: Dict, tokens: torch.Tensor,
            lengths: torch.Tensor, block_tables: torch.Tensor, cfg,
            plain: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Batched prefill: run the right-padded prompts [B, S] through causal
    attention once and write every layer's K/V into the pool (in place).
    Padding positions (>= lengths[b]) are masked out of the writes. An
    int8 pool gets quantized codes and scales; attention itself stays in
    the compute dtype, as in the reference.
    Returns (logits at each row's last valid token [B, 1, V], cache)."""
    b, s = tokens.shape
    num_pages, page_size = pool_geometry(cache)
    h = embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None, :].expand(b, s)
    write = L.plan_page_write(*L.page_slots(
        block_tables, positions, page_size, num_pages,
        keep=positions < lengths[:, None]))
    rope = L.rope_table(positions, L.rope_dim(cfg), cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        hn = L.rmsnorm(h, lp["ln1"], cfg.norm_eps)
        if cfg.family == "mla_moe":
            # the latent row (post-norm c_kv ++ post-RoPE k_rope) pages
            # as the one pool
            a, latent = MLA.mla_prefill_paged(lp["attn"], hn, cfg, rope,
                                              plain)
            L.write_pages_(cache["lat_pages"][i], write, latent)
            h = h + a
        else:
            q, k, v = L.attn_qkv(lp["attn"], hn, positions, cfg, plain,
                                 rope)
            o = L.causal_attention(q, k, v)
            h = h + apply_linear(lp["attn"]["wo"], o.reshape(b, s, -1),
                                 plain=plain)
            L.write_kv_(layer_cache(cache, i), write, k, v)
        hn = L.rmsnorm(h, lp["ln2"], cfg.norm_eps)
        h = h + _mixer(lp, hn, cfg, plain)[0]
    last = (lengths.long() - 1).clamp_min(0)
    h_last = h[torch.arange(b, device=h.device), last][:, None]
    return unembed(params, h_last, cfg), cache


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg,
                block_tables: Optional[torch.Tensor] = None,
                max_live_pages: Optional[int] = None,
                plain: bool = False,
                tree: Optional[Dict] = None,
                feed_len: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens: [B, T]. ``cache`` is the paged pool of
    :func:`init_paged_cache` (``block_tables`` [B, MP] required; pos: [B]
    per-slot write positions, token t lands at pos + t) or the contiguous
    cache of :func:`init_cache` (T = 1; pos: [] shared step index or [B]
    per-slot positions; no ``tree``), told apart by their keys as the
    reference does. Writes the cache in place.

    ``tree`` switches the T fed tokens to token-tree semantics:
    ``{"depths": [T], "anc": [T], "window": int, "start": int}`` — RoPE at
    the tree depth, ancestor-bitmap masking over the fed window
    (``layers.paged_block_geometry``). Only the first ``cfg.n_layers``
    layers of ``cache`` are read and written (a depth-pruned draft passes
    its own shallower config).

    ``feed_len`` [B] (paged pool only) makes the T-token feed ragged: slot
    b's tokens at t >= feed_len[b] are padding, their K/V writes are
    dropped and their logits are to be discarded by the caller (the
    prefix cache's tail prefill: unshared prompt tails of different
    lengths padded to one T).

    ``max_live_pages`` clamps the block tables to the batch's max occupied
    page count: every slot's reservation fits in the leading entries, so
    the trailing all-sentinel columns carry no information. Returns
    (logits [B, T, V], cache)."""
    if "k_pages" not in cache and "lat_pages" not in cache:
        if tree is not None:
            raise ValueError("token-tree decode requires the paged cache")
        if feed_len is not None:
            raise ValueError("ragged feed_len requires the paged cache")
        return _decode_contiguous(params, cache, tokens, pos, cfg,
                                  plain), cache
    if block_tables is None:
        raise ValueError("paged cache decode requires block_tables")
    if max_live_pages is not None:
        block_tables = block_tables[
            :, :max(1, min(max_live_pages, block_tables.shape[1]))]
    num_pages, page_size = pool_geometry(cache)
    # positions, rotations and pool rows are the same in every layer
    step = L.paged_step(block_tables, pos, tokens.shape[1], page_size,
                        num_pages, cfg, tree, feed_len)
    h = embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        hn = L.rmsnorm(h, lp["ln1"], cfg.norm_eps)
        if cfg.family == "mla_moe":
            h = h + MLA.mla_decode_paged(lp["attn"], hn,
                                         layer_cache(cache, i), cfg, step,
                                         plain)
        else:
            h = h + L.attention_decode_paged(lp["attn"], hn,
                                             layer_cache(cache, i),
                                             step.block_tables, pos, cfg,
                                             plain, step)
        hn = L.rmsnorm(h, lp["ln2"], cfg.norm_eps)
        h = h + _mixer(lp, hn, cfg, plain)[0]
    return unembed(params, h, cfg), cache
