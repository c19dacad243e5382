"""Shared building blocks: norms, RoPE, full-sequence attention, decode
attention on the paged pool and on the contiguous cache, MLP. Every
linear routes through ``core.gqs_layer.apply_linear`` so the blocks
accept FP or packed-GQSA parameters alike.

``plain=True`` (kernel-vs-plain checks only) sends the kernels' work
through their plain PyTorch versions even on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.gqs_layer import apply_linear
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import attention_scale


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_dim(cfg) -> int:
    """Width of the rotated part of a head: the whole head of the dense
    family, the ``qk_rope`` parts of MLA (64 at DeepSeek-V2 width, where
    ``cfg.hd`` = d_model / n_heads = 40 is not a head width at all)."""
    return cfg.mla.qk_rope_dim if cfg.family == "mla_moe" else cfg.hd


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [..., S, 1, D/2], for :func:`apply_rope`. Every
    layer of a step rotates at the same positions, so the model computes
    the table once per step."""
    freqs = rope_freqs(head_dim, theta, positions.device)   # [D/2]
    ang = positions[..., None].float() * freqs              # [..., S, D/2]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               table=None) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable); ``table``:
    a precomputed :func:`rope_table` of those positions."""
    cos, sin = table if table is not None \
        else rope_table(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# prefill attention: plain causal attention in f32 (the reference's
# blocked flash attention is plain XLA code, not a Pallas kernel)
# ---------------------------------------------------------------------------

def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q, k: [B, S, H | KH, D]; v: [B, S, KH, Dv]; H % KH == 0. Returns
    [B, S, H, Dv] in q's dtype; scores, softmax and sums in f32, scale
    1/sqrt(D) (MLA prefill: D = nope + rope = 192, Dv = 128)."""
    b, s, h, d = q.shape
    kh, dv = k.shape[2], v.shape[-1]
    r = h // kh
    qh = q.reshape(b, s, kh, r, d).permute(0, 2, 3, 1, 4).float()
    kk = k.permute(0, 2, 1, 3).float()[:, :, None]           # [B,KH,1,S,D]
    vv = v.permute(0, 2, 1, 3).float()[:, :, None]
    sco = (qh @ kk.transpose(-1, -2)) * attention_scale(d)   # [B,KH,R,S,S]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    sco = sco.masked_fill(~causal, -torch.inf)
    o = torch.softmax(sco, dim=-1) @ vv                      # [B,KH,R,S,Dv]
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# masks and paged geometry
# ---------------------------------------------------------------------------

def query_lengths(length, b: int, t: int, device=None) -> torch.Tensor:
    """Broadcast a [] / [B] / [B, T] valid-prefix spec to [B, T]."""
    lq = torch.as_tensor(length, device=device)
    if lq.ndim == 1:
        lq = lq[:, None]
    return lq.expand(b, t)


def staircase_mask(length, b: int, t: int, s: int) -> torch.Tensor:
    """[B, T, S] validity: cache position s is visible to query (b, t) iff
    s < length[b, t] (T = 1 degenerates to a plain prefix mask)."""
    lq = query_lengths(length, b, t)
    pos = torch.arange(s, device=lq.device)
    return pos[None, None, :] < lq[..., None]


def ancestor_mask(length, anc: Optional[torch.Tensor],
                  base: Optional[torch.Tensor], window: int, b: int, t: int,
                  s: int) -> torch.Tensor:
    """[B, T, S] token-tree validity, the generalization of
    :func:`staircase_mask` (which stays the chain case, ``anc is None``).

    A speculative token tree is fed as one flat BFS block of ``window``
    tokens written at cache positions ``base .. base + window - 1``. Query
    (b, t) sees cache position s iff s < length[b, t] and, when s falls
    inside the fed window, bit ``s - base[b]`` of ``anc[b, t]`` is set
    (the bitmap holds the query's root-to-self path, so siblings stay
    invisible)."""
    m = staircase_mask(length, b, t, s)
    if anc is None:
        return m
    fed = (torch.arange(s, dtype=torch.int32, device=m.device)[None, None, :]
           - base.to(torch.int32)[:, None, None])           # [B, 1, S]
    in_win = (fed >= 0) & (fed < window)
    bits = (anc.to(torch.int32).expand(b, t)[:, :, None]
            >> fed.clamp(0, 31)) & 1                        # [B, T, S]
    return m & (~in_win | (bits == 1))


def paged_block_geometry(positions: torch.Tensor, t: int,
                         tree: Optional[Dict] = None):
    """``positions`` [B] is the write position of each slot's first fed
    token (token t lands at positions + t). Returns ``(pos_bt [B, T] write
    positions, rope_pos [B, T], length [B, T] per-query valid prefix,
    base [B] | None, anc [B, T] | None, window)``: the chain staircase
    when ``tree`` is None, else the token-tree block (RoPE at the tree
    depth ``base + depths``, length ``base + window`` for every query,
    ancestor bitmaps over the fed window; storage stays slot-sequential).
    ``tree``: ``{"depths": [T], "anc": [T] int32 tensors, "window": int,
    "start": int}`` (``engine/spec/tree.py:TreeTemplate``)."""
    b = positions.shape[0]
    pos_bt = positions[:, None].to(torch.int32) + torch.arange(
        t, dtype=torch.int32, device=positions.device)[None, :]
    if tree is None:
        return pos_bt, pos_bt, pos_bt + 1, None, None, 0
    window = int(tree["window"])
    base = positions.to(torch.int32) - int(tree["start"])
    rope_pos = base[:, None] + tree["depths"][None, :].to(torch.int32)
    length = (base + window)[:, None].expand(b, t)
    anc = tree["anc"][None, :].to(torch.int32).expand(b, t)
    return pos_bt, rope_pos, length, base, anc, window


def page_slots(block_tables: torch.Tensor, pos: torch.Tensor,
               page_size: int, num_pages: int,
               keep: torch.Tensor = None) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Pool row of each token position: ``(flat [..] = page * ps + off,
    valid [..])``. ``pos``: [B, S] positions of slot b.

    The reference leans on XLA here: an out-of-range gather clamps and an
    out-of-range scatter is dropped. PyTorch raises or faults instead, so
    the write mask is explicit: a position is written only if its table
    column exists (column < MP), its page is real (page < P, not the
    sentinel) and ``keep`` allows it. The table read itself is clamped."""
    mp = block_tables.shape[1]
    col = pos // page_size
    page = torch.gather(block_tables, 1, col.clamp(0, mp - 1).long())
    valid = (col < mp) & (page >= 0) & (page < num_pages)
    if keep is not None:
        valid = valid & keep
    flat = torch.where(valid, page * page_size + pos % page_size, 0)
    return flat.long(), valid


@dataclasses.dataclass
class PageWrite:
    """Where a step's token rows land in the pool, planned once per step
    (every layer writes the same rows).

    Without a host sync the dropped entries cannot be filtered out, so
    they are redirected onto the first kept entry and carry that entry's
    own value: every index written more than once then receives one
    value, and the scatter stays deterministic. With no kept entry at
    all, the entries rewrite row 0 with its current contents. No index
    here is a 0-dim tensor: indexing with one reads it on the host, a
    sync per layer."""
    index: torch.Tensor      # [N] pool rows (dropped -> first kept row)
    src: torch.Tensor        # [N] entry whose value each write carries
    any_kept: torch.Tensor   # () bool


def plan_page_write(flat: torch.Tensor, valid: torch.Tensor) -> PageWrite:
    """From :func:`page_slots`' ``(flat, valid)``."""
    flat, valid = flat.reshape(-1), valid.reshape(-1)
    first = torch.argmax(valid.to(torch.int32)).reshape(1)  # 0: none kept
    entry = torch.arange(flat.shape[0], device=flat.device)
    return PageWrite(index=torch.where(valid, flat,
                                       flat.index_select(0, first)),
                     src=torch.where(valid, entry, first),
                     any_kept=valid.any())


def write_pages_(buf: torch.Tensor, plan: PageWrite,
                 new: torch.Tensor) -> None:
    """In place: ``buf`` [P, ps, ...] gets ``new``'s token rows at the kept
    entries of ``plan``; the other entries are dropped."""
    rows = buf.view(-1, *buf.shape[2:])                 # [P*ps, ...]
    new = new.reshape(plan.index.shape[0], *rows.shape[1:]).to(buf.dtype)
    vals = torch.where(plan.any_kept, new.index_select(0, plan.src),
                       rows.index_select(0, plan.index))
    rows.index_put_((plan.index,), vals)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., KH, D] -> (int8 codes, f32 scale [..., KH]) per token + head:
    scale = amax / 127, codes rounded half to even and clipped to +-127."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def write_kv_(cache: Dict, plan: PageWrite, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """In place: one layer's pool ({"k_pages", "v_pages"} and, for an
    int8 pool, {"k_scale_pages", "v_scale_pages"}) gets the token rows of
    ``k``/``v`` [..., KH, D] at the kept entries of ``plan``; an int8 pool
    stores them quantized (:func:`quantize_kv`)."""
    if "k_scale_pages" in cache:
        (k, k_sc), (v, v_sc) = quantize_kv(k), quantize_kv(v)
        write_pages_(cache["k_scale_pages"], plan, k_sc)
        write_pages_(cache["v_scale_pages"], plan, v_sc)
    write_pages_(cache["k_pages"], plan, k)
    write_pages_(cache["v_pages"], plan, v)


# ---------------------------------------------------------------------------
# attention blocks
# ---------------------------------------------------------------------------

def attn_qkv(p: Dict, x: torch.Tensor, positions: torch.Tensor, cfg,
             plain: bool = False, rope=None):
    b, s, _ = x.shape
    h, khn, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = apply_linear(p["wq"], x, plain=plain).reshape(b, s, h, hd)
    k = apply_linear(p["wk"], x, plain=plain).reshape(b, s, khn, hd)
    v = apply_linear(p["wv"], x, plain=plain).reshape(b, s, khn, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k = apply_rope(k, positions, cfg.rope_theta, rope)
    return q, k, v


@dataclasses.dataclass
class PagedStep:
    """Operands of a paged decode step that every layer shares, computed
    once per step by :func:`paged_step`."""
    block_tables: torch.Tensor    # [B, MP] int32, contiguous
    length: torch.Tensor          # [B, T] per-query valid prefix
    rope: Tuple[torch.Tensor, torch.Tensor]
    write: PageWrite
    kernel_prep: Tuple[torch.Tensor, torch.Tensor]   # (lengths, live pages)
    # token-tree block (None / 0 on the chain staircase)
    anc: Optional[torch.Tensor] = None    # [B, T] int32, contiguous
    base: Optional[torch.Tensor] = None   # [B] int32
    window: int = 0


def paged_step(block_tables: torch.Tensor, positions: torch.Tensor, t: int,
               page_size: int, num_pages: int, cfg,
               tree: Optional[Dict] = None) -> PagedStep:
    """``tree``: a token-tree block (:func:`paged_block_geometry`)."""
    block_tables = block_tables.to(torch.int32).contiguous()
    pos_bt, rope_pos, length, base, anc, window = paged_block_geometry(
        positions, t, tree)
    flat, valid = page_slots(block_tables, pos_bt, page_size, num_pages)
    return PagedStep(
        block_tables=block_tables, length=length,
        rope=rope_table(rope_pos, rope_dim(cfg), cfg.rope_theta),
        write=plan_page_write(flat, valid),
        kernel_prep=kops.paged_query_prep(length, block_tables,
                                          positions.shape[0], t, page_size),
        anc=None if anc is None else anc.contiguous(), base=base,
        window=window)


def attention_decode_paged(p: Dict, x: torch.Tensor, cache: Dict,
                           block_tables: torch.Tensor,
                           positions: torch.Tensor, cfg,
                           plain: bool = False,
                           step: Optional[PagedStep] = None,
                           tree: Optional[Dict] = None) -> torch.Tensor:
    """One decode step of T tokens against one layer's view of the paged
    pool, which it writes IN PLACE: {"k_pages"/"v_pages": [P, ps, KH, D]}
    in bf16 or f32, or int8 codes with {"k_scale_pages"/"v_scale_pages":
    [P, ps, KH]} f32 (the token's K/V are quantized before the write, and
    the kernel dequantizes each tile before its f32 contractions).

    x: [B, T, d]; positions: [B] write position of each slot's first
    token; block_tables: [B, MP] page ids (sentinel entries: writes
    dropped, reads clamped and masked by the per-query length). The K/V of
    all T tokens are written before attention reads them, so query t sees
    the earlier fed tokens exactly as a sequential decode would.
    ``tree`` switches the block to token-tree semantics
    (:func:`paged_block_geometry`): RoPE at the tree depth, the ancestor
    mask over the fed window (the kernel's tree mode).
    ``step``: the step's shared operands (:func:`paged_step`), which the
    model computes once for all layers; built here when absent."""
    b, t, _ = x.shape
    kp = cache["k_pages"]
    if step is None:
        step = paged_step(block_tables, positions, t, kp.shape[1],
                          kp.shape[0], cfg, tree)
    q, k, v = attn_qkv(p, x, None, cfg, plain, rope=step.rope)
    write_kv_(cache, step.write, k, v)
    o = kops.paged_decode_attention(
        q, kp, cache["v_pages"], step.length, step.block_tables,
        cache.get("k_scale_pages"), cache.get("v_scale_pages"),
        anc=step.anc, anc_base=step.base, anc_window=step.window,
        plain=plain, prep=step.kernel_prep).to(q.dtype)
    return apply_linear(p["wo"], o.reshape(b, t, -1), plain=plain)


def attention_block(p: Dict, x: torch.Tensor, positions: torch.Tensor, cfg,
                    plain: bool = False, rope=None) -> torch.Tensor:
    """Full-sequence causal attention (forward / prefill): x [B, S, d] at
    ``positions`` [B, S] (``rope``: their :func:`rope_table`)."""
    b, s, _ = x.shape
    q, k, v = attn_qkv(p, x, positions, cfg, plain, rope)
    o = causal_attention(q, k, v)
    return apply_linear(p["wo"], o.reshape(b, s, -1), plain=plain)


# ---------------------------------------------------------------------------
# contiguous cache (static batch): [B, S, ...] per layer, one token a step
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """Short-query attention against a contiguous bf16/f32 cache, plain
    PyTorch, the reference's math: q [B, T, H, D] cast to the cache's
    dtype, products summed in f32, p cast to the values' dtype before
    P.V. k_cache [B, S, KH, D]; v_cache [B, S, KH, Dv]; length [] / [B] /
    [B, T] valid prefix per query. Returns [B, T, H, Dv] in q's dtype
    (rows of length 0: NaN, as the reference's)."""
    b, s, khn, d = k_cache.shape
    dv = v_cache.shape[-1]
    t, h = q.shape[1], q.shape[2]
    r = h // khn
    # the cache's dtype rounds q; the products of two bf16 values are exact
    # in f32, so f32 operands give the reference's f32-accumulated dot
    qh = q.reshape(b, t, khn, r, d).to(k_cache.dtype).float()
    sco = torch.einsum("btkrd,bskd->bkrts", qh, k_cache.float()) \
        * attention_scale(d)
    valid = staircase_mask(length, b, t, s)[:, None, None]   # [B,1,1,T,S]
    sco = torch.where(valid, sco, -torch.inf)
    p = torch.softmax(sco, dim=-1).to(v_cache.dtype).float()
    o = torch.einsum("bkrts,bskd->btkrd", p, v_cache.float())
    return o.reshape(b, t, h, dv).to(q.dtype)


@dataclasses.dataclass
class CacheWrite:
    """Where a contiguous decode step writes its token in every layer: row
    ``slot`` [B] at position ``index`` [B], kept where ``keep`` [B]. A
    write at ``pos >= max_seq`` is dropped (the reference's shared-``pos``
    update clamps it into the last position and its per-slot one drops
    it); ``index`` is clamped so the dropped entry rewrites its own old
    value. No index is a 0-dim tensor (a host read per layer)."""
    slot: torch.Tensor
    index: torch.Tensor
    keep: torch.Tensor


def plan_cache_write(pos: torch.Tensor, b: int, max_seq: int) -> CacheWrite:
    """``pos``: [] shared or [B] per-slot write position."""
    pos = torch.as_tensor(pos).reshape(-1).expand(b).long()
    return CacheWrite(slot=torch.arange(b, device=pos.device),
                      index=pos.clamp(0, max_seq - 1), keep=pos < max_seq)


def write_cache_(buf: torch.Tensor, w: CacheWrite,
                 new: torch.Tensor) -> None:
    """In place: ``buf`` [B, S, ...] gets ``new`` [B, 1, ...] at each kept
    slot's position."""
    new = new[:, 0].to(buf.dtype)
    keep = w.keep.reshape((-1,) + (1,) * (new.ndim - 1))
    buf.index_put_((w.slot, w.index),
                   torch.where(keep, new, buf[w.slot, w.index]))


def attention_decode(p: Dict, x: torch.Tensor, cache: Dict,
                     pos: torch.Tensor, cfg, plain: bool = False,
                     rope=None, write: Optional[CacheWrite] = None
                     ) -> torch.Tensor:
    """One decode step of one token against one layer's contiguous cache,
    which it writes IN PLACE: {"k"/"v": [B, S, KH, D]} in bf16 or f32, or
    int8 codes with {"k_scale"/"v_scale": [B, S, KH]} f32 (the token's K/V
    quantized by :func:`quantize_kv`).

    x: [B, 1, d]; pos: [] shared step index or [B] per-slot positions;
    query b sees positions < pos + 1. The int8 cache always takes the
    kernel's math (``ops.kv_decode_attention``: dequantized tiles, f32
    products), for a shared and a per-slot ``pos`` alike; the reference
    takes it only for a shared ``pos`` under ``use_pallas`` and
    re-quantizes q and p otherwise (ROADMAP C.4). The bf16/f32 cache
    takes :func:`decode_attention`. ``rope`` / ``write``: the step's
    :func:`rope_table` and :func:`plan_cache_write`, which the model
    computes once for all layers; built here when absent."""
    b = x.shape[0]
    h, khn, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    positions = torch.as_tensor(pos).reshape(-1, 1).expand(b, 1)
    if write is None:
        write = plan_cache_write(pos, b, cache["k"].shape[1])
    q, k, v = attn_qkv(p, x, positions, cfg, plain, rope)
    if "k_scale" in cache:
        (k, k_sc), (v, v_sc) = quantize_kv(k), quantize_kv(v)
        for name, new in (("k", k), ("v", v), ("k_scale", k_sc),
                          ("v_scale", v_sc)):
            write_cache_(cache[name], write, new)
        o = kops.kv_decode_attention(
            q.reshape(b, khn, h // khn, hd), cache["k"], cache["k_scale"],
            cache["v"], cache["v_scale"], pos + 1, plain=plain)
        o = o.reshape(b, 1, h, hd).to(x.dtype)
    else:
        write_cache_(cache["k"], write, k)
        write_cache_(cache["v"], write, v)
        o = decode_attention(q, cache["k"], cache["v"], pos + 1)
    return apply_linear(p["wo"], o.reshape(b, 1, -1), plain=plain)


def mlp_block(p: Dict, x: torch.Tensor, mlp_type: str,
              plain: bool = False) -> torch.Tensor:
    if mlp_type == "swiglu":
        g = apply_linear(p["wg"], x, plain=plain)
        u = apply_linear(p["wu"], x, plain=plain)
        return apply_linear(p["wd"], F.silu(g) * u, plain=plain)
    u = apply_linear(p["wu"], x, plain=plain)
    return apply_linear(p["wd"], F.gelu(u, approximate="tanh"), plain=plain)
