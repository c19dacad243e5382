"""Public kernel entry points: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The choice follows only the device of the inputs (and an explicit
``plain=True``, which the kernel-vs-plain checks pass): on the card a
dispatcher launches the kernel or raises, it never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.core.bsr import BSRMatrix
from repro_torch.kernels import ref as kref
from repro_torch.kernels.gqsa_gemv import (gqsa_gemv_cuda,
                                           gqsa_gemv_experts_cuda)
from repro_torch.kernels.kv_decode_attention import \
    kv_decode_attention_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.w4_matmul import (w4_matmul_cuda,
                                           w4_matmul_experts_cuda)


def _use_plain(t: torch.Tensor, plain: bool, name: str) -> bool:
    if plain or t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return False


def gqsa_gemv(x: torch.Tensor, bsr: BSRMatrix, *,
              plain: bool = False) -> torch.Tensor:
    """y [B, N] f32 = x [B, K] @ dense(bsr).T, any B.

    On the card, one launch at any B (prefill sends slots x bucket rows
    through here, a tree verify slots x tree tokens), at group size 8, 16,
    32, 64 or 128; another group size raises there (ROADMAP.md B.8)."""
    if _use_plain(x, plain, "gqsa_gemv"):
        return kref.gqsa_gemv_ref(x, bsr)
    return gqsa_gemv_cuda(x.contiguous(), bsr)


def gqsa_gemv_experts(x: torch.Tensor, bsr: BSRMatrix,
                      rows: torch.Tensor = None, *,
                      plain: bool = False) -> torch.Tensor:
    """The routed experts' products: y [E, C, N] f32 with y[e] = x[e]
    [C, K] @ dense(expert e of the stacked bsr).T, any C.

    ``rows`` [E]: how many leading buffer rows of each expert hold
    tokens; the others come out as zeros, and on the card an expert with
    none is not read. On the card every expert and all C rows go through
    one launch of the kernel's expert axis, which finds the occupied
    experts from ``rows`` itself, at group size 8, 16, 32, 64 or 128
    (another raises there)."""
    if _use_plain(x, plain, "gqsa_gemv_experts"):
        return kref.gqsa_gemv_experts_ref(x, bsr, rows)
    if rows is not None:
        rows = rows.to(torch.int32).contiguous()
    return gqsa_gemv_experts_cuda(x.contiguous(), bsr, rows)


def paged_query_prep(lengths, block_tables: torch.Tensor, b: int, t: int,
                     page_size: int):
    """The reference's ``_paged_query_prep``: broadcast the [] / [B] /
    [B, T] length spec to the kernel's [B, T] int32 operand and derive
    each slot's live page count (ceil(max_t length / page_size), clipped to
    the table width), on the device, with no host sync."""
    from repro_torch.models.layers import query_lengths
    lq = query_lengths(lengths, b, t, block_tables.device) \
        .to(torch.int32).contiguous()
    mp = block_tables.shape[1]
    live = torch.clamp((lq.amax(dim=1) + page_size - 1) // page_size, 0, mp)
    return lq, live.to(torch.int32)


def paged_decode_attention(q, k_pages, v_pages, lengths, block_tables,
                           k_scale_pages=None, v_scale_pages=None, *,
                           anc=None, anc_base=None, anc_window: int = 0,
                           plain: bool = False, prep=None):
    """Decode attention on the paged KV pool (plain, int8 or tree mode).

    q: [B, T, H, D] (T=1 decode); k/v_pages: [P, ps, KH, D] bf16/f32, or
    int8 with f32 [P, ps, KH] ``k/v_scale_pages`` (int8 mode: each tile is
    dequantized before the f32 contractions); lengths: [] / [B] / [B, T]
    per-query valid prefix; block_tables: [B, MP] page ids, entries >= P
    are sentinels. Returns [B, T, H, D] f32 (rows of length 0 are zeros).
    ``anc`` [B, T] / ``anc_base`` [B] / ``anc_window`` switch the fed
    block to token-TREE semantics (``models/layers.py:ancestor_mask``):
    query t also needs bit ``s - anc_base[b]`` of ``anc[b, t]`` for cache
    positions s inside the fed window.
    ``prep``: :func:`paged_query_prep` of these lengths, when the caller
    already has it."""
    if _use_plain(q, plain, "paged_decode_attention"):
        return kref.paged_attention_ref(q, k_pages, v_pages, lengths,
                                        block_tables, k_scale_pages,
                                        v_scale_pages, anc=anc,
                                        anc_base=anc_base,
                                        anc_window=anc_window)
    b, t, h, d = q.shape
    page_size, khn = k_pages.shape[1], k_pages.shape[2]
    r = h // khn
    lq, live = prep if prep is not None else paged_query_prep(
        lengths, block_tables, b, t, page_size)
    # kernel row layout: [B, KH, T*R, D], T-major inside the row dim
    qh = q.reshape(b, t, khn, r, d).permute(0, 2, 1, 3, 4) \
          .reshape(b, khn, t * r, d).float().contiguous()
    if anc is not None:
        anc = anc.to(torch.int32).expand(b, t).contiguous()
        anc_base = anc_base.to(torch.int32).contiguous()
    o = paged_attention_cuda(qh, k_pages, v_pages, lq,
                             block_tables.to(torch.int32).contiguous(),
                             live, t, k_scale_pages, v_scale_pages, anc,
                             anc_base, anc_window)
    return o.reshape(b, khn, t, r, d).permute(0, 2, 1, 3, 4) \
            .reshape(b, t, h, d)


def w4_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
              zero: torch.Tensor, *, group_size: int,
              plain: bool = False) -> torch.Tensor:
    """y [T, N] f32 = x [T, K] @ deq(qw).T (dense grouped dequant), any
    T >= 1.

    On the card the kernel masks ragged T, N and K edges itself, so
    nothing is padded or copied (the weights stay where they are)."""
    if _use_plain(x, plain, "w4_matmul"):
        return kref.w4_matmul_ref(x, qw, scale, zero, group_size)
    return w4_matmul_cuda(x.contiguous(), qw, scale, zero, group_size)


def w4_matmul_experts(x: torch.Tensor, qw: torch.Tensor,
                      scale: torch.Tensor, zero: torch.Tensor,
                      rows: torch.Tensor = None, *, group_size: int,
                      plain: bool = False) -> torch.Tensor:
    """The routed experts' dense-W4 products: y [E, C, N] f32 with y[e] =
    x[e] [C, K] @ deq(qw[e], scale[e], zero[e]).T, any C.

    ``rows`` [E]: how many leading buffer rows of each expert hold
    tokens; the others come out as zeros, and on the card an expert with
    none is not read. On the card every expert and all C rows go through
    one launch of the kernel's expert axis."""
    if _use_plain(x, plain, "w4_matmul_experts"):
        return kref.w4_matmul_experts_ref(x, qw, scale, zero, rows,
                                          group_size)
    if rows is not None:
        rows = rows.to(torch.int32).contiguous()
    return w4_matmul_experts_cuda(x.contiguous(), qw, scale, zero, rows,
                                  group_size)


def paged_latent_attention(q, lat_pages, lengths, block_tables, *,
                           v_rank: int, anc=None, anc_base=None,
                           anc_window: int = 0, plain: bool = False,
                           prep=None):
    """Decode attention on the paged MLA latent pool (the kernel's latent
    mode).

    q: [B, T, H, R + rope] absorbed-W_UK queries, pre-scaled by
    sqrt(fake/true) (``models/mla.py:absorbed_q``; the kernel divides by
    sqrt(R + rope)); lat_pages: [P, ps, R + rope], one logical KV head of
    post-norm c_kv ++ post-RoPE k_rope per token; lengths / block_tables
    / ``anc`` as :func:`paged_decode_attention`. Returns the latent
    context [B, T, H, v_rank] f32: a token's value is the leading
    ``v_rank`` (= kv_lora_rank) dims of its row, and W_UV is applied by
    the caller after attention. ``prep``: :func:`paged_query_prep` of
    these lengths, when the caller already has it."""
    if _use_plain(q, plain, "paged_latent_attention"):
        return kref.paged_latent_attention_ref(
            q, lat_pages, lengths, block_tables, v_rank, anc=anc,
            anc_base=anc_base, anc_window=anc_window)
    b, t, h, d = q.shape
    lq, live = prep if prep is not None else paged_query_prep(
        lengths, block_tables, b, t, lat_pages.shape[1])
    # kernel row layout: [B, KH=1, T*H, D], T-major inside the row dim
    qh = q.reshape(b, 1, t * h, d).float().contiguous()
    if anc is not None:
        anc = anc.to(torch.int32).expand(b, t).contiguous()
        anc_base = anc_base.to(torch.int32).contiguous()
    o = paged_attention_cuda(qh, lat_pages[:, :, None, :], None, lq,
                             block_tables.to(torch.int32).contiguous(),
                             live, t, anc=anc, anc_base=anc_base,
                             window=anc_window, v_rank=v_rank)
    return o.reshape(b, t, h, v_rank)


def kv_decode_attention(q, k_cache, k_scale, v_cache, v_scale, length, *,
                        plain: bool = False):
    """int8-KV decode attention over a contiguous cache: q [B, KH, R, D];
    k/v_cache int8 [B, S, KH, D]; k/v_scale f32 [B, S, KH]; length [] /
    [B] valid prefix. Returns [B, KH, R, D] f32 (rows of length 0 are
    zeros).

    On the card, the kernel of ``csrc/kv_decode_attention.cu``, one
    launch a call (its split combine included), counted in
    ``kv_decode_attention_cuda.launches``. The length is read on the
    device and the split count comes from shapes, so nothing is read on
    the host; a layer slice of a [L, B, S, KH, D] buffer reaches the
    kernel as it is."""
    if _use_plain(q, plain, "kv_decode_attention"):
        return kref.kv_decode_attention_ref(q, k_cache, k_scale, v_cache,
                                            v_scale, length)
    return kv_decode_attention_cuda(q.float().contiguous(), k_cache, k_scale,
                                    v_cache, v_scale, length)
