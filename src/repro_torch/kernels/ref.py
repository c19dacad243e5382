"""Plain PyTorch versions of the kernels: the port's CPU path and the
oracles that the CUDA kernels are held against on the card.

Same math as the reference's oracles (``src/repro/kernels/ref.py``), with
one deliberate difference: an attention row (paged plain or latent, or
the contiguous int8 cache) whose length is 0 returns exact zeros, as both
the TPU and the CUDA kernels do, where the reference's oracle returns NaN.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bsr import BSRMatrix, to_dense
from repro_torch.core.quant import unpack_int4


def gqsa_gemv_experts_ref(x: torch.Tensor, bsr: BSRMatrix,
                          rows: torch.Tensor = None) -> torch.Tensor:
    """The routed experts' products: x [E, C, K] -> y [E, C, N] f32 with
    y[e] = :func:`gqsa_gemv_ref` (x[e], expert e of the stacked ``bsr``
    ([E, N, M] leaves)). One expert at a time, so at most one expert's
    dense f32 operand exists (31 MB at DeepSeek-V2 width; all 160 at once
    would be 5 GB per projection). ``rows`` [E]: rows at or past
    ``rows[e]`` are zeros (the kernel skips them); every expert is
    computed either way."""
    e, c, _ = x.shape
    y = torch.empty((e, c, bsr.shape[0]), dtype=torch.float32,
                    device=x.device)
    for i in range(e):
        y[i] = gqsa_gemv_ref(x[i], bsr.layer(i))
    if rows is not None:
        keep = torch.arange(c, device=x.device)[None, :] < rows[:, None]
        y = torch.where(keep[..., None], y, 0.0)
    return y


def gqsa_gemv_ref(x: torch.Tensor, bsr: BSRMatrix) -> torch.Tensor:
    """Sparse-quantized GEMV / skinny GEMM: x [B, K] -> y [B, N] with
    y[b,n] = sum_m deq(vals[n,m]) . x[b, idx[n,m]G : +G].

    The kept groups are dequantized once and scattered into a dense [N, K]
    f32 operand (padding slots carry scale 0 and scatter-add zeros), then
    contracted with one f32 matmul. Returns f32."""
    return x.float() @ to_dense(bsr).T


def gqsa_gemv_grouped_ref(x: torch.Tensor, bsr: BSRMatrix) -> torch.Tensor:
    """:func:`gqsa_gemv_ref` in the CUDA kernel's order of arithmetic
    (tests only): per work item, d = sum_j q_j x_j over the raw codes and
    xs = sum_j x_j of its column line, in f32, then y += s * d - (s * z)
    * xs, items in order (padding slots: column 0, scale 0). At g <= 32
    an item is a kept slot and its line the slot's column group; above,
    a slot is g / 32 items, its parts of 32 codes in order, part p
    reading 32-column line max(idx, 0) * g / 32 + p with the slot's s and
    z. x widened to f32 exactly."""
    n, m = bsr.idx.shape
    t, k = x.shape
    line = min(bsr.group_size, 32)
    parts = bsr.group_size // line
    q = unpack_int4(bsr.vals).float().reshape(n, m * parts, line)
    xg = x.float().reshape(t, k // line, line)
    xs = xg.sum(-1)                                            # [T, K/line]
    col = (bsr.idx.clamp_min(0).long()[..., None] * parts
           + torch.arange(parts, device=x.device)).reshape(n, m * parts)
    scale = bsr.scale.repeat_interleave(parts, dim=1)          # [N, items]
    zero = bsr.zero.repeat_interleave(parts, dim=1)
    y = torch.zeros((t, n), dtype=torch.float32, device=x.device)
    for i in range(m * parts):
        d = torch.einsum("tng,ng->tn", xg[:, col[:, i]], q[:, i])
        s = scale[:, i]
        y = y + s * d - (s * zero[:, i]) * xs[:, col[:, i]]
    return y


def gqsa_gemv_experts_grouped_ref(x: torch.Tensor, bsr: BSRMatrix,
                                  rows: torch.Tensor = None) -> torch.Tensor:
    """:func:`gqsa_gemv_experts_ref` in the CUDA expert kernel's order of
    arithmetic (tests only): expert e's first ``rows[e]`` buffer rows (all
    C when ``rows`` is None) through :func:`gqsa_gemv_grouped_ref`, every
    other row exact zeros; an expert with no row is not read at all (its
    leaves may hold anything)."""
    e, c, _ = x.shape
    y = torch.zeros((e, c, bsr.shape[0]), dtype=torch.float32,
                    device=x.device)
    for i in range(e):
        r = c if rows is None else min(max(int(rows[i]), 0), c)
        if r:
            y[i, :r] = gqsa_gemv_grouped_ref(x[i, :r], bsr.layer(i))
    return y


def w4_matmul_ref(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                  zero: torch.Tensor, group_size: int) -> torch.Tensor:
    """Dense grouped-dequant matmul (the W4A16 baseline): x [T, K] ->
    y [T, N] f32 = x @ deq(qw).T, with qw packed uint8 [N, K/2] (element
    2i in the low nibble), scale/zero [N, K/G] and deq = (q - zero) *
    scale in f32, x widened to f32."""
    n = qw.shape[0]
    q = unpack_int4(qw).float()                                # [N, K]
    qg = q.reshape(n, -1, group_size)
    w = ((qg - zero[..., None]) * scale[..., None]).reshape(n, -1)
    return x.float() @ w.T


def w4_matmul_experts_ref(x: torch.Tensor, qw: torch.Tensor,
                          scale: torch.Tensor, zero: torch.Tensor,
                          rows: torch.Tensor, group_size: int
                          ) -> torch.Tensor:
    """The routed experts' dense-W4 products: x [E, C, K] -> y [E, C, N]
    f32 with y[e] = :func:`w4_matmul_ref` (x[e], qw[e], scale[e],
    zero[e]), qw [E, N, K/2] and scale / zero [E, N, K/G]. One expert at a
    time, so at most one expert's dense f32 operand exists. ``rows`` [E]
    or None: rows at or past ``rows[e]`` are zeros (the kernel skips
    them); every expert is computed either way."""
    e, c, _ = x.shape
    y = torch.empty((e, c, qw.shape[1]), dtype=torch.float32,
                    device=x.device)
    for i in range(e):
        y[i] = w4_matmul_ref(x[i], qw[i], scale[i], zero[i], group_size)
    if rows is not None:
        keep = torch.arange(c, device=x.device)[None, :] < rows[:, None]
        y = torch.where(keep[..., None], y, 0.0)
    return y


def w4_matmul_grouped_ref(x: torch.Tensor, qw: torch.Tensor,
                          scale: torch.Tensor, zero: torch.Tensor,
                          group_size: int) -> torch.Tensor:
    """:func:`w4_matmul_ref` in the order of arithmetic of the kernel's
    tensor-core path (tests only): per group, d = sum q x over the raw
    codes and xs = sum x, then y += s * d - (s * z) * xs, groups in order.
    f32 x enters as bf16 hi + lo (hi = bf16(x), lo = bf16(x - hi)), bf16 x
    as it is."""
    n = qw.shape[0]
    t, k = x.shape
    q = unpack_int4(qw).float().reshape(n, k // group_size, group_size)
    if x.dtype == torch.bfloat16:
        parts = [x.float()]
    else:
        hi = x.float().to(torch.bfloat16).float()
        parts = [hi, (x.float() - hi).to(torch.bfloat16).float()]
    parts = [p.reshape(t, k // group_size, group_size) for p in parts]
    d = sum(torch.einsum("tgk,ngk->tng", p, q) for p in parts)
    xs = sum(p.sum(-1) for p in parts)                         # [T, K/G]
    y = torch.zeros((t, n), dtype=torch.float32, device=x.device)
    for i in range(k // group_size):
        s = scale[:, i]
        y = y + s * d[:, :, i] - (s * zero[:, i]) * xs[:, i, None]
    return y


def attention_scale(d: int) -> float:
    """1/sqrt(D) rounded as f32 arithmetic rounds it (the reference and
    the kernel compute it in f32); exact as a Python float."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def kv_decode_attention_ref(q, k_cache, k_scale, v_cache, v_scale, length):
    """int8-KV decode attention over a contiguous cache, in f32.

    q: [B, KH, R, D]; k/v_cache: int8 [B, S, KH, D]; k/v_scale: f32
    [B, S, KH] (dequantized as code * scale); length: [] / [B] valid
    prefix. Returns [B, KH, R, D] f32; rows of length 0 are zeros (the
    reference's oracle returns NaN there)."""
    b, s, khn, d = k_cache.shape
    k = k_cache.float() * k_scale[..., None]
    v = v_cache.float() * v_scale[..., None]
    sco = torch.einsum("bkrd,bskd->bkrs", q.float(), k) * attention_scale(d)
    lq = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    valid = (torch.arange(s, device=q.device)[None, :] < lq)[:, None, None]
    sco = torch.where(valid, sco, -torch.inf)
    p = torch.where(valid, torch.softmax(sco, dim=-1), 0.0)
    return torch.einsum("bkrs,bskd->bkrd", p, v)


def kv_decode_split_ref(q, k_cache, k_scale, v_cache, v_scale, length,
                        n_split: int):
    """:func:`kv_decode_attention_ref` computed as the CUDA kernel
    (``csrc/kv_decode_attention.cu``) computes it (tests only): each
    slot's live length (clipped to [0, S]) is cut into n = ceil(length /
    ``CHUNK``) chunks and split i of ``n_split`` takes chunks [i * n //
    n_split, (i + 1) * n // n_split); each split keeps, per query row,
    m = its largest score, l = the sum of e^(score - m) and acc = the sum
    of (e^(score - m) * v_scale) * codes, a score being (q . codes) *
    (1/sqrt(D) * k_scale); :func:`merge_splits` merges them in split
    order. Returns [B, KH, R, D] f32; rows of length 0 are zeros."""
    from repro_torch.kernels.kv_decode_attention import CHUNK
    b, s, khn, d = k_cache.shape
    lq = torch.as_tensor(length, device=q.device).reshape(-1).expand(b)
    lq = lq.clamp(0, s)
    n = (lq + CHUNK - 1) // CHUNK                                  # [B]
    pos = torch.arange(s, device=q.device)
    c = pos // CHUNK
    sco = torch.einsum("bkrd,bskd->bkrs", q.float(), k_cache.float())
    sco = sco * (attention_scale(d) * k_scale.transpose(1, 2))[:, :, None]
    vs = v_scale.transpose(1, 2)[:, :, None]                       # [B,KH,1,S]
    ms, ls, accs = [], [], []
    for i in range(n_split):
        c0, c1 = i * n // n_split, (i + 1) * n // n_split
        vis = ((pos[None] < lq[:, None]) & (c[None] >= c0[:, None])
               & (c[None] < c1[:, None]))[:, None, None]           # [B,1,1,S]
        sc = torch.where(vis, sco, -torch.inf)
        m = sc.amax(dim=-1)
        e = torch.where(vis, torch.exp(sc - torch.where(
            torch.isinf(m), 0.0, m)[..., None]), 0.0)
        ms.append(m)
        ls.append(e.sum(dim=-1))
        accs.append(torch.einsum("bkrs,bskd->bkrd", e * vs, v_cache.float()))
    return merge_splits(torch.stack(ms), torch.stack(ls), torch.stack(accs))


def paged_attention_ref(q, k_pages, v_pages, lengths, block_tables,
                        k_scale_pages=None, v_scale_pages=None, *, anc=None,
                        anc_base=None, anc_window: int = 0):
    """Dense page gather followed by staircase attention, in f32.

    q: [B, T, H, D]; k/v_pages: [P, ps, KH, D] (bf16/f32, or int8 with f32
    [P, ps, KH] scale pages, dequantized after the gather as code *
    scale); lengths: [] / [B] / [B, T] per-query valid prefix;
    block_tables: [B, MP] page ids — entries >= P are sentinels and clamp
    to P - 1, their positions masked by ``lengths``. ``anc`` [B, T] /
    ``anc_base`` [B] / ``anc_window``: the tree mode's ancestor bitmaps
    (``models/layers.py:ancestor_mask``). Returns [B, T, H, D] f32; rows
    of length 0 are zeros."""
    from repro_torch.models.layers import ancestor_mask
    b, t, h, d = q.shape
    num_pages, ps, khn, _ = k_pages.shape
    r = h // khn
    bt = block_tables.long().clamp(0, num_pages - 1)
    k = k_pages[bt].reshape(b, -1, khn, d).float()
    v = v_pages[bt].reshape(b, -1, khn, d).float()
    if k_scale_pages is not None:
        k = k * k_scale_pages[bt].reshape(b, -1, khn, 1)
        v = v * v_scale_pages[bt].reshape(b, -1, khn, 1)
    s = k.shape[1]
    qh = q.reshape(b, t, khn, r, d).float()
    sco = torch.einsum("btkrd,bskd->bkrts", qh, k) * attention_scale(d)
    valid = ancestor_mask(lengths, anc, anc_base, anc_window, b, t,
                          s)[:, None, None]                 # [B,1,1,T,S]
    sco = torch.where(valid, sco, -torch.inf)
    # an all-masked row softmaxes to NaN; the mask zeroes it, as the
    # kernels' l = 0 guard does
    p = torch.where(valid, torch.softmax(sco, dim=-1), 0.0)
    o = torch.einsum("bkrts,bskd->btkrd", p, v)
    return o.reshape(b, t, h, d)


def paged_attention_split_partials(q, k_pages, v_pages, lengths,
                                   block_tables, n_split: int,
                                   k_scale_pages=None, v_scale_pages=None, *,
                                   anc=None, anc_base=None,
                                   anc_window: int = 0, v_rank: int = 0):
    """The per-split partials of the CUDA kernel's split page walk: split
    i of ``n_split`` takes each slot's live pages i, i + n_split, ...
    (live = ceil(max_t length / ps), clipped to the table width, as
    ``ops.paged_query_prep`` derives it) and keeps, per query row, m = its
    largest visible score, l = the sum of e^(score - m) and acc = the sum
    of e^(score - m) v. A split with no visible position for a row has
    m = -inf, l = 0, acc = 0.

    Arguments as :func:`paged_attention_ref`. int8 pages take the
    kernel's folded math: a score is (q . codes) * (k_scale / sqrt(D)),
    and acc sums (e^(score - m) * v_scale) * codes while l sums
    e^(score - m). ``v_pages=None`` is the latent pool: k_pages [P, ps, D]
    (one KV head), each row's value its leading ``v_rank`` dims, as
    :func:`paged_latent_attention_ref`. Returns (m [S, B, T, H],
    l [S, B, T, H], acc [S, B, T, H, DV]) in f32."""
    from repro_torch.models.layers import ancestor_mask, query_lengths
    latent = v_pages is None
    if latent:
        k_pages = k_pages[:, :, None, :]
    b, t, h, d = q.shape
    num_pages, ps, khn, _ = k_pages.shape
    mp = block_tables.shape[1]
    r = h // khn
    bt = block_tables.long().clamp(0, num_pages - 1)
    k = k_pages[bt].reshape(b, -1, khn, d).float()
    v = k[..., :v_rank] if latent \
        else v_pages[bt].reshape(b, -1, khn, d).float()
    s = k.shape[1]
    qh = q.reshape(b, t, khn, r, d).float()
    sco = torch.einsum("btkrd,bskd->bkrts", qh, k)
    if k_scale_pages is None:
        sco = sco * attention_scale(d)
    else:                                                   # [B, KH, S]
        ks, vs = (sc[bt].reshape(b, -1, khn).transpose(1, 2)
                  for sc in (k_scale_pages, v_scale_pages))
        sco = sco * (attention_scale(d) * ks)[:, :, None, None, :]
    lq = query_lengths(lengths, b, t, q.device)
    live = torch.clamp((lq.amax(dim=1) + ps - 1) // ps, 0, mp)      # [B]
    page = torch.arange(s, device=q.device) // ps                  # [S]
    valid = ancestor_mask(lengths, anc, anc_base, anc_window, b, t, s) \
        & (page[None, :] < live[:, None])[:, None, :]              # [B,T,S]
    valid = valid[:, None, None]                                   # [B,1,1,T,S]
    ms, ls, accs = [], [], []
    for i in range(n_split):
        vis = valid & (page % n_split == i)
        sc = torch.where(vis, sco, -torch.inf)
        m = sc.amax(dim=-1)                                        # [B,KH,R,T]
        e = torch.where(vis, torch.exp(sc - torch.where(
            torch.isinf(m), 0.0, m)[..., None]), 0.0)
        pv = e if k_scale_pages is None else e * vs[:, :, None, None, :]
        acc = torch.einsum("bkrts,bskd->bkrtd", pv, v)
        for lst, x in ((ms, m), (ls, e.sum(dim=-1)), (accs, acc)):
            # [B, KH, R, T, ...] -> [B, T, H, ...]
            lst.append(x.movedim(3, 1).reshape(b, t, h, *x.shape[4:]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def paged_attention_split_ref(q, k_pages, v_pages, lengths, block_tables,
                              n_split: int, k_scale_pages=None,
                              v_scale_pages=None, *, anc=None, anc_base=None,
                              anc_window: int = 0, v_rank: int = 0):
    """:func:`paged_attention_ref` (int8 pages included) or, with
    ``v_pages=None``, :func:`paged_latent_attention_ref`, computed as the
    CUDA kernel's split walk computes it: the partials of
    :func:`paged_attention_split_partials`, merged in split order with
    m = max m_i, l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m) / l
    (splits with m_i = -inf skipped; a row with none left is zeros).
    Returns [B, T, H, DV] f32."""
    m_i, l_i, acc_i = paged_attention_split_partials(
        q, k_pages, v_pages, lengths, block_tables, n_split, k_scale_pages,
        v_scale_pages, anc=anc, anc_base=anc_base, anc_window=anc_window,
        v_rank=v_rank)
    return merge_splits(m_i, l_i, acc_i)


def merge_splits(m_i, l_i, acc_i):
    """The split kernels' combine: partials m_i, l_i [S, ...] and acc_i
    [S, ..., DV] merged in split order as m = max m_i, l = sum l_i
    e^(m_i - m), o = sum acc_i e^(m_i - m) / l (splits with m_i = -inf
    skipped; a row with none left is zeros)."""
    m = m_i.amax(dim=0)
    w = torch.where(torch.isinf(m_i), 0.0,
                    torch.exp(m_i - torch.where(torch.isinf(m), 0.0, m)))
    den = torch.clamp_min((l_i * w).sum(dim=0), 1e-30)
    return (acc_i * w[..., None]).sum(dim=0) / den[..., None]


def paged_latent_attention_ref(q, lat_pages, lengths, block_tables,
                               v_rank: int, *, anc=None, anc_base=None,
                               anc_window: int = 0):
    """The MLA latent pool's attention: one logical KV head whose value is
    the leading ``v_rank`` dims of the same row (no V pool).

    q: [B, T, H, D] absorbed, pre-scaled queries (D = R + rope); lat_pages:
    [P, ps, D]; lengths / block_tables / ``anc`` as in
    :func:`paged_attention_ref` (sentinels clamp to P - 1, scale
    1/sqrt(D)). Returns [B, T, H, v_rank] f32; rows of length 0 are zeros
    (the reference's oracle returns NaN there, its kernel zeros)."""
    from repro_torch.models.layers import ancestor_mask
    b, t, h, d = q.shape
    num_pages = lat_pages.shape[0]
    bt = block_tables.long().clamp(0, num_pages - 1)
    k = lat_pages[bt].reshape(b, -1, d).float()             # [B, S, D]
    s = k.shape[1]
    sco = torch.einsum("bthd,bsd->bhts", q.float(), k) * attention_scale(d)
    valid = ancestor_mask(lengths, anc, anc_base, anc_window, b, t,
                          s)[:, None]                       # [B,1,T,S]
    sco = torch.where(valid, sco, -torch.inf)
    p = torch.where(valid, torch.softmax(sco, dim=-1), 0.0)
    return torch.einsum("bhts,bsd->bthd", p, k[..., :v_rank])


def tree_attention_ref(q, k_pages, v_pages, lengths, block_tables, anc,
                       anc_base, anc_window: int, k_scale_pages=None,
                       v_scale_pages=None):
    """Token-TREE paged attention: the T fed queries are a flat BFS token
    tree written at cache positions ``anc_base .. anc_base + anc_window -
    1``; ``anc`` [B, T] holds each query's root-to-self path as a bitmap
    over that window. Everything else is :func:`paged_attention_ref` (the
    staircase is the chain, every bitmap a prefix of ones)."""
    return paged_attention_ref(q, k_pages, v_pages, lengths, block_tables,
                               k_scale_pages, v_scale_pages, anc=anc,
                               anc_base=anc_base, anc_window=anc_window)
