"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434) on the paged
latent pool and on the contiguous latent cache.

KV is compressed to a rank-``kv_lora_rank`` latent plus one shared RoPE
key head; the pool stores one row of ``kv_lora_rank + qk_rope_dim`` per
token (post-norm ``c_kv`` ++ post-RoPE ``k_rope``), one logical KV head
and no V pool. Prefill attends unabsorbed (K and V up-projected once for
the whole sequence); decode uses the absorbed form: q_nope goes through
W_UK so scores contract against the latent rows directly, and the context
goes through W_UV after attention (the latent mode of the paged-attention
kernel in between; on the contiguous cache, plain attention as in the
reference).

w_qa / w_qb / w_kva / wo are GQS-compressible linears; w_uk / w_uv stay
dense f32 and are cast to the activation dtype before their einsums, as
the reference does (it computes them outside Pallas too).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.gqs_layer import apply_linear
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def mla_q(p: Dict, x: torch.Tensor, cfg, rope,
          plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (q_nope [B, S, H, nope], q_rope [B, S, H, rope]);
    ``rope``: the :func:`layers.rope_table` of the tokens' positions at
    the rope width."""
    m = cfg.mla
    b, s, _ = x.shape
    cq = L.rmsnorm(apply_linear(p["w_qa"], x, plain=plain), p["q_norm"],
                   cfg.norm_eps)
    q = apply_linear(p["w_qb"], cq, plain=plain).reshape(
        b, s, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    return q_nope, L.apply_rope(q_rope, None, cfg.rope_theta, rope)


def mla_kv_latent(p: Dict, x: torch.Tensor, cfg, rope,
                  plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (post-norm c_kv [B, S, R], post-RoPE k_rope
    [B, S, rope])."""
    m = cfg.mla
    ckv = apply_linear(p["w_kva"], x, plain=plain)
    c_kv, k_rope = torch.split(ckv, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = L.rmsnorm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(k_rope[:, :, None, :], None, cfg.rope_theta,
                          rope)[:, :, 0, :]
    return c_kv, k_rope


def mla_prefill_paged(p: Dict, x: torch.Tensor, cfg, rope,
                      plain: bool = False) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Full-sequence causal MLA and the latent row each token pages.
    Returns (attn_out [B, S, d], latent [B, S, R + rope])."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = mla_q(p, x, cfg, rope, plain)
    c_kv, k_rope = mla_kv_latent(p, x, cfg, rope, plain)
    k_nope = torch.einsum("bsr,hdr->bshd", c_kv, p["w_uk"].to(c_kv.dtype))
    v = torch.einsum("bsr,hvr->bshv", c_kv, p["w_uv"].to(c_kv.dtype))
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = L.causal_attention(q, k, v)                          # [B,S,H,v]
    out = apply_linear(p["wo"], o.reshape(b, s, -1), plain=plain)
    return out, torch.cat([c_kv, k_rope], dim=-1)


def mla_block(p: Dict, x: torch.Tensor, cfg, rope,
              plain: bool = False) -> torch.Tensor:
    """Full-sequence causal MLA (forward / prefill). x: [B, S, d] ->
    [B, S, d]; ``rope`` as :func:`mla_q`."""
    return mla_prefill_paged(p, x, cfg, rope, plain)[0]


def mla_cache_init(cfg, batch: int, max_seq: int, dtype,
                   device=None) -> Dict:
    """One layer's contiguous latent cache: post-norm ``c_kv`` [B, S, R]
    and post-RoPE ``k_rope`` [B, S, rope], zeroed."""
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_seq, m.qk_rope_dim),
                                  dtype=dtype, device=device)}


def absorbed_q(p: Dict, q_nope: torch.Tensor, q_rope: torch.Tensor,
               cfg) -> torch.Tensor:
    """W_UK absorbed into q, so scores contract against the latent rows:
    [B, T, H, nope/rope] -> [B, T, H, R + rope], pre-scaled by
    sqrt(fake/true) so that the kernel's 1/sqrt(R + rope) gives the
    unabsorbed 1/sqrt(nope + rope). The factor is rounded to f32 and then
    to q's dtype, as the reference rounds it."""
    m = cfg.mla
    q_lat = torch.einsum("bshd,hdr->bshr", q_nope,
                         p["w_uk"].to(q_nope.dtype))
    q_cat = torch.cat([q_lat, q_rope], dim=-1)
    fake = m.kv_lora_rank + m.qk_rope_dim
    true = m.qk_nope_dim + m.qk_rope_dim
    factor = torch.tensor(float(np.sqrt(np.float32(fake / true))),
                          dtype=torch.float32, device=q_cat.device)
    return q_cat * factor.to(q_cat.dtype)


def mla_decode_paged(p: Dict, x: torch.Tensor, cache: Dict, cfg,
                     step: L.PagedStep, plain: bool = False) -> torch.Tensor:
    """T-token absorbed MLA decode against one layer's view of the paged
    latent pool ``{"lat_pages": [P, ps, R + rope]}``, which it writes IN
    PLACE (every token's row before attention reads the pool, so query t
    sees the earlier fed tokens as a sequential decode would).

    x: [B, T, d]; ``step``: the step's shared operands
    (:func:`layers.paged_step`: write plan, RoPE table at the rope width,
    staircase or tree lengths, kernel prep). Returns attn_out [B, T, d]."""
    m = cfg.mla
    b, t, _ = x.shape
    lat = cache["lat_pages"]
    q_nope, q_rope = mla_q(p, x, cfg, step.rope, plain)
    c_kv, k_rope = mla_kv_latent(p, x, cfg, step.rope, plain)
    L.write_pages_(lat, step.write, torch.cat([c_kv, k_rope], dim=-1))
    q = absorbed_q(p, q_nope, q_rope, cfg)                  # [B,T,H,R+r]
    ctx = kops.paged_latent_attention(
        q, lat, step.length, step.block_tables, v_rank=m.kv_lora_rank,
        anc=step.anc, anc_base=step.base, anc_window=step.window,
        plain=plain, prep=step.kernel_prep).to(q.dtype)
    v = torch.einsum("bshr,hvr->bshv", ctx, p["w_uv"].to(ctx.dtype))
    return apply_linear(p["wo"], v.reshape(b, t, -1), plain=plain)


def mla_decode(p: Dict, x: torch.Tensor, cache: Dict, pos, cfg, rope,
               write: L.CacheWrite, plain: bool = False) -> torch.Tensor:
    """Absorbed single-token decode against one layer's contiguous latent
    cache ``{"c_kv": [B, S, R], "k_rope": [B, S, rope]}``, which it writes
    IN PLACE before attention reads it. Attention is
    :func:`layers.decode_attention` over the concatenated latent rows (one
    KV head; the values are the ``c_kv`` part), plain PyTorch as in the
    reference.

    x: [B, 1, d]; pos: [] shared or [B] per-slot positions (the reference
    takes a shared one only); ``rope``: the step's rope-width table;
    ``write``: its :func:`layers.plan_cache_write`. Returns [B, 1, d]."""
    b = x.shape[0]
    q_nope, q_rope = mla_q(p, x, cfg, rope, plain)
    c_kv_new, k_rope_new = mla_kv_latent(p, x, cfg, rope, plain)
    L.write_cache_(cache["c_kv"], write, c_kv_new)
    L.write_cache_(cache["k_rope"], write, k_rope_new)
    c_kv = cache["c_kv"]
    q = absorbed_q(p, q_nope, q_rope, cfg)                  # [B,1,H,R+r]
    k_cat = torch.cat([c_kv, cache["k_rope"]], dim=-1)[:, :, None, :]
    ctx = L.decode_attention(q, k_cat, c_kv[:, :, None, :], pos + 1)
    v = torch.einsum("bshr,hvr->bshv", ctx, p["w_uv"].to(ctx.dtype))
    return apply_linear(p["wo"], v.reshape(b, 1, -1), plain=plain)
