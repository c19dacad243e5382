"""Paged decode attention (plain, int8, tree and latent modes): the
wrapper of the hand-written CUDA kernel
(``repro_torch/csrc/paged_attention.cu``). Its plain PyTorch versions are
``kernels/ref.py:paged_attention_ref`` and ``paged_latent_attention_ref``.

Replaces the TPU kernel
``src/repro/kernels/paged_attention.py:paged_attention_pallas`` in plain
mode (bf16/f32 pages), in int8 mode (int8 pages with f32 [P, ps, KH]
scale pages, ``kv_cache_dtype="int8"``), which decode attention on the
paged KV pool reaches every step, in tree mode (ancestor bitmaps over
the fed window), which token-tree speculation reaches at every draft
level and verify, and in latent mode (``v_pages=None``: the MLA latent
pool, one KV head of D = 576 whose value is its leading ``v_rank`` = 512
dims), which every DeepSeek-V2 decode step reaches in every layer.

Bound on the H100: bytes in every mode. Each live K/V element is read
once and used for two multiply-adds per query row; the floor is the live
K/V bytes (int8: codes plus scales) over 3.35 TB/s, under the bf16
tensor cores' balance in every mode. The latent mode (each 1152-byte bf16
row serves all T*H = 128 query rows, ~0.28 MFLOP a row) and the tree
verify do so many operations a byte that this kernel's f32 products on
the CUDA cores outlast the bytes at long lengths.

Design, every mode: the page walk is split across blocks. Split s of S
takes each slot's live pages s, s+S, ...; a block of up to
``SPLIT_ROWS`` query rows stages chunks of up to 4 pages raw in shared
memory with ``cp.async``, computes whole q.k dot products a thread
(warps over rows, lanes over positions) and one online-softmax update a
chunk, and writes its partial (m, l, acc) to a workspace this wrapper
allocates; a second small kernel merges the S partials in split order,
so two launches give bit-identical output. S comes from host-known
shapes only (:func:`split_count`): reading ``live`` or ``lengths`` on
the host would put a sync in every decode step. Sentinel block-table
entries clamp to page P - 1 and are masked by length; a row of length 0
returns zeros. The plain version of the split, partials and combine
included, is ``kernels/ref.py:paged_attention_split_ref``.

The int8 mode stages the codes raw and each token's two scales in the
pads of its staged rows; it folds the k scale into the score and the v
scale into the probability instead of dequantizing every code.

The latent mode stages one ring of rows (V is the leading ``v_rank``
dims of K) and takes ``WIDE_ROWS`` rows a block, each of 256 threads a
column pair of the 512 value columns.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.build import load, sm_count

SPLIT_ROWS = 32         # query rows per block
SPLIT_MAX_VALUE_DIM = 512  # a column pair a thread, 256 threads
SPLIT_MAX_PAGE = 64     # positions a staged chunk holds
WIDE_ROWS = 16          # value widths past 256 (latent): rows per block
SPLIT_WAVES = 2         # blocks aimed at per SM of the card


# paged_attention_launch(q, k, v, page_kind, k/v scales, lengths, tables,
# live, anc, anc_base, window, out, B..MP, workspace, n_split, stream)
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int]
                   + [ctypes.c_void_p] + [ctypes.c_int] * 9
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("paged_attention").paged_attention_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def split_count(b: int, khn: int, tr: int, mp: int, sms: int, ps: int,
                dv: int = 0) -> int:
    """Splits S of each slot's page walk, from host-known shapes only: the
    power of two at or below the count that gives ``SPLIT_WAVES`` (slot,
    KV head, row group, split) blocks per SM (a table of a power-of-two
    width then splits evenly), and no more splits than the table's ``mp``
    columns fill chunks of ``SPLIT_MAX_PAGE`` positions, since below a
    chunk a split saves no load and the combine kernel costs its own
    launch. Row groups are ``SPLIT_ROWS`` rows, or ``WIDE_ROWS`` for a
    value width ``dv`` past 256, the latent mode's. At 4 slots x 32 KV
    heads on 132 SMs with pages of 16: S = 2 for a 16-column table, 1 for
    a table of at most 4 columns (the engine passes its live width); the
    latent mode's 4 slots x 8 row groups: S = 4 for a 16-column table."""
    rows = WIDE_ROWS if dv > 256 else SPLIT_ROWS
    blocks = b * khn * -(-tr // rows)
    want = -(-SPLIT_WAVES * sms // blocks)
    chunks = -(-mp // max(1, SPLIT_MAX_PAGE // ps))
    return max(1, min(chunks, 1 << (want.bit_length() - 1)))


def workspace_floats(b: int, khn: int, tr: int, dv: int,
                     n_split: int) -> int:
    """f32 elements of the split walk's workspace: partial acc
    [B, KH, S, TR, DV] then (m, l) pairs [B, KH, S, TR, 2]; none at S = 1,
    where the split kernel writes the output itself."""
    return 0 if n_split == 1 else b * khn * n_split * tr * (dv + 2)


def _check(t: torch.Tensor, name: str, dtypes, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"paged_attention: {name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"paged_attention: {name} must be one of {dtypes}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"paged_attention: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"paged_attention: {name} must be contiguous")


PAGE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: Optional[torch.Tensor],
                         lengths: torch.Tensor,
                         block_tables: torch.Tensor, live: torch.Tensor,
                         t: int, k_scale_pages: Optional[torch.Tensor] = None,
                         v_scale_pages: Optional[torch.Tensor] = None,
                         anc: Optional[torch.Tensor] = None,
                         anc_base: Optional[torch.Tensor] = None,
                         window: int = 0, v_rank: int = 0,
                         n_split: Optional[int] = None) -> torch.Tensor:
    """out [B, KH, T*R, D] f32 on the card ([B, 1, T*H, v_rank] in the
    latent mode).

    q: [B, KH, T*R, D] f32 (T-major rows); k/v_pages: [P, ps, KH, D] bf16
    or f32 (plain mode), or int8 with f32 [P, ps, KH] ``k/v_scale_pages``
    (int8 mode); lengths: [B, T] int32; block_tables: [B, MP] int32
    (entries >= P are sentinels); live: [B] int32 live page counts.
    Tree mode: ``anc`` [B, T] int32 ancestor bitmaps, ``anc_base`` [B]
    int32 window bases and the fed ``window`` width, on any page type.
    Latent mode: ``v_pages=None``, k_pages the latent pool [P, ps, 1, D]
    (bf16 or f32), each row's value its leading ``v_rank`` dims; it takes
    the tree mode's operands too.
    Every mode walks the pages over ``n_split`` splits (default
    :func:`split_count` of the shapes; at most the block-table width).
    Plain-mode launches count in ``launches``, int8-mode launches in
    ``int8_launches``, tree-mode launches (any page type) in
    ``tree_launches``, latent-mode launches (tree or not) in
    ``latent_launches`` and, those with tree operands, also in
    ``latent_tree_launches``, one a call whatever number of kernels it
    launches."""
    b, khn, tr, d = q.shape
    p, ps = k_pages.shape[0], k_pages.shape[1]
    mp = block_tables.shape[1]
    latent = v_pages is None
    dv = v_rank if latent else d
    if tr % t:
        raise ValueError(f"paged_attention_cuda takes T*R rows (a multiple "
                         f"of T), got T*R={tr}, T={t}")
    if latent and (k_pages.dtype == torch.int8 or khn != 1
                   or not 1 <= v_rank <= d):
        raise NotImplementedError(
            "paged_attention_cuda: the latent mode takes one KV head of "
            "bf16/f32 pages and 1 <= v_rank <= D (int8 latent pages are "
            "not supported, as in the reference)")
    tree = anc is not None
    if tree != (anc_base is not None) or window < 0:
        raise ValueError("paged_attention_cuda: the tree mode takes anc, "
                         "anc_base and a window >= 0 together")
    int8 = k_pages.dtype == torch.int8
    if int8 != (k_scale_pages is not None) \
            or (k_scale_pages is None) != (v_scale_pages is None):
        raise ValueError("paged_attention_cuda: int8 pages take both scale "
                         "pages, bf16/f32 pages take none")
    _check(q, "q", (torch.float32,), (b, khn, tr, d))
    _check(k_pages, "k_pages", tuple(PAGE_KINDS), (p, ps, khn, d))
    if not latent:
        _check(v_pages, "v_pages", (k_pages.dtype,), (p, ps, khn, d))
    if int8:
        _check(k_scale_pages, "k_scale_pages", (torch.float32,), (p, ps, khn))
        _check(v_scale_pages, "v_scale_pages", (torch.float32,), (p, ps, khn))
    _check(lengths, "lengths", (torch.int32,), (b, t))
    _check(block_tables, "block_tables", (torch.int32,), (b, mp))
    _check(live, "live", (torch.int32,), (b,))
    if tree:
        _check(anc, "anc", (torch.int32,), (b, t))
        _check(anc_base, "anc_base", (torch.int32,), (b,))
    if n_split is None:
        n_split = split_count(b, khn, tr, mp, sm_count(
            q.device.index if q.device.index is not None
            else torch.cuda.current_device()), ps, dv)
    vec = 16 // k_pages.element_size()         # elements per 16-byte load
    if d % vec or dv % 2 or dv > SPLIT_MAX_VALUE_DIM or ps > SPLIT_MAX_PAGE \
            or not 1 <= n_split <= max(mp, 1):
        raise ValueError(
            f"paged_attention_cuda: the page walk takes D a multiple of "
            f"{vec}, an even value width <= {SPLIT_MAX_VALUE_DIM}, page "
            f"size <= {SPLIT_MAX_PAGE} and 1 <= n_split <= {max(mp, 1)}; got "
            f"D={d}, value width {dv}, page size {ps}, n_split={n_split}")
    if k_pages.data_ptr() % 16 or (not latent and v_pages.data_ptr() % 16):
        raise ValueError("paged_attention_cuda: pages must be 16-byte "
                         "aligned (vector loads)")
    if q.data_ptr() % 16:                      # staged with 16-byte copies
        q = q.clone()
    out = torch.empty((b, khn, tr, dv), dtype=torch.float32,
                      device=q.device)
    ws = workspace_floats(b, khn, tr, dv, n_split)
    work = torch.empty(ws, dtype=torch.float32, device=q.device) \
        if ws else None
    rc = _launcher()(q.data_ptr(), k_pages.data_ptr(),
                     None if latent else v_pages.data_ptr(),
                     PAGE_KINDS[k_pages.dtype],
                     k_scale_pages.data_ptr() if int8 else None,
                     v_scale_pages.data_ptr() if int8 else None,
                     lengths.data_ptr(), block_tables.data_ptr(),
                     live.data_ptr(), anc.data_ptr() if tree else None,
                     anc_base.data_ptr() if tree else None, window,
                     out.data_ptr(), b, khn, tr, t, d, dv, p, ps, mp,
                     None if work is None else work.data_ptr(), n_split,
                     torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:     # 1: shapes the launcher refuses (shared memory too)
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {rc}")
    if latent:
        paged_attention_cuda.latent_launches += 1
        paged_attention_cuda.latent_tree_launches += int(tree)
    elif tree:
        paged_attention_cuda.tree_launches += 1
    elif int8:
        paged_attention_cuda.int8_launches += 1
    else:
        paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0        # plain mode (bf16/f32 pages)
paged_attention_cuda.int8_launches = 0   # int8 mode
paged_attention_cuda.tree_launches = 0   # tree mode (any page type)
paged_attention_cuda.latent_launches = 0  # latent mode (tree or not)
paged_attention_cuda.latent_tree_launches = 0  # latent mode, tree operands
