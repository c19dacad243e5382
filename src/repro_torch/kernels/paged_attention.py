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

Bound on the H100: bytes in the plain, int8 and tree modes. Each live K/V
element is read once and used for two f32 multiply-adds per query row;
the floor is the live K/V bytes (int8: codes plus scales) over 3.35 TB/s.
The latent mode is bound by operations at long lengths: each 1152-byte
bf16 row serves all T*H = 128 query rows (~0.28 MFLOP per row).

Design, bf16/f32 pages in the plain and tree modes (every decode step and
tree verify of the main path): the page walk is split across blocks.
Split s of S takes each slot's live pages s, s+S, ...; a block of up to
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

The int8 mode keeps the earlier walk: one block per (slot, KV head, group
of at most ``MAX_ROWS`` rows) walks the slot's pages in order, staging
each page's K and V tiles in shared memory dequantized (code * scale);
more rows take more row groups, each walking the pages again.

The latent mode stages one tile per page (V is K), gives each thread
``LATENT_COLS`` value columns (576 threads of one column each would
exceed a block's registers) and takes ``LATENT_ROWS`` rows a block (46 KB
of shared memory at D = 576): decode's 128 rows make 32 row groups a
slot, 128 blocks at 4 slots, so the slots' page walks fill the card (16
rows a block left 100 of its 132 SMs idle and ran 3.1-3.5x slower).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.build import load

MAX_ROWS = 16           # int8 mode: query rows per block
MAX_HEAD_DIM = 1024
SPLIT_ROWS = 32         # split walk: query rows per block
SPLIT_MAX_HEAD_DIM = 256   # split walk: a column pair a thread, 128 threads
SPLIT_MAX_PAGE = 64     # split walk: positions a staged chunk holds
SPLIT_WAVES = 2         # split walk: blocks aimed at per SM of the card
SMEM_LIMIT = 232448     # dynamic shared memory a block may opt in to
STAGE = 8               # 16-byte loads per thread per K/V page tile
LATENT_COLS = 2         # latent mode: value columns per thread
LATENT_ROWS = 4         # latent mode: query rows per block


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_count(b: int, khn: int, tr: int, mp: int, sms: int,
                ps: int) -> int:
    """Splits S of each slot's page walk (bf16/f32 pages, plain and tree
    modes), from host-known shapes only: the power of two at or below the
    count that gives ``SPLIT_WAVES`` (slot, KV head, row group, split)
    blocks per SM (a table of a power-of-two width then splits evenly),
    and no more splits than the table's ``mp`` columns fill chunks of
    ``SPLIT_MAX_PAGE`` positions, since below a chunk a split saves no
    load and the combine kernel costs its own launch. At 4 slots x 32 KV
    heads on 132 SMs with pages of 16: S = 2 for a 16-column table, 1 for
    a table of at most 4 columns (the engine passes its live width)."""
    blocks = b * khn * -(-tr // SPLIT_ROWS)
    want = -(-SPLIT_WAVES * sms // blocks)
    chunks = -(-mp // max(1, SPLIT_MAX_PAGE // ps))
    return max(1, min(chunks, 1 << (want.bit_length() - 1)))


def workspace_floats(b: int, khn: int, tr: int, d: int, n_split: int) -> int:
    """f32 elements of the split walk's workspace: partial acc
    [B, KH, S, TR, D] then (m, l) pairs [B, KH, S, TR, 2]; none at S = 1,
    where the split kernel writes the output itself."""
    return 0 if n_split == 1 else b * khn * n_split * tr * (d + 2)


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
    bf16/f32 pages outside the latent mode take the split walk over
    ``n_split`` splits (default :func:`split_count` of the shapes; at most
    the block-table width); the int8 and latent modes ignore it.
    Plain-mode launches count in ``launches``, int8-mode launches in
    ``int8_launches``, tree-mode launches (any page type) in
    ``tree_launches``, latent-mode launches (tree or not) in
    ``latent_launches``, one a call whatever number of kernels it
    launches."""
    b, khn, tr, d = q.shape
    p, ps = k_pages.shape[0], k_pages.shape[1]
    mp = block_tables.shape[1]
    latent = v_pages is None
    dv = v_rank if latent else d
    if tr % t or d > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention_cuda takes T*R rows (a multiple "
                         f"of T) and D <= {MAX_HEAD_DIM}, got T*R={tr}, "
                         f"T={t}, D={d}")
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
    vec = 16 // k_pages.element_size()         # elements per 16-byte load
    split = not latent and not int8
    if split:
        if n_split is None:
            n_split = split_count(b, khn, tr, mp, _sm_count(
                q.device.index if q.device.index is not None
                else torch.cuda.current_device()), ps)
        if d > SPLIT_MAX_HEAD_DIM or d % vec or ps > SPLIT_MAX_PAGE \
                or not 1 <= n_split <= max(mp, 1):
            raise ValueError(
                f"paged_attention_cuda: the split walk takes D <= "
                f"{SPLIT_MAX_HEAD_DIM} (a multiple of {vec}), page size <= "
                f"{SPLIT_MAX_PAGE} and 1 <= n_split <= {max(mp, 1)}; got "
                f"D={d}, page size {ps}, n_split={n_split}")
    else:
        n_split = 1
        rows = min(tr, LATENT_ROWS if latent else MAX_ROWS)
        tiles = 1 if latent else 2             # the latent V is the K tile
        smem = 4 * (rows * d + tiles * ps * d + rows * ps + 3 * rows)
        if latent:
            cols = -(-dv // LATENT_COLS)   # threads holding value columns
            threads, stage = -(-cols // 32) * 32, 2 * STAGE
        else:
            threads, stage = -(-d // 32) * 32, STAGE
        if smem > SMEM_LIMIT or d % vec or ps * d // vec > stage * threads:
            raise ValueError(
                f"paged_attention_cuda: page size {ps} x head dim {d} does "
                f"not fit the kernel's staging ({smem} bytes of shared "
                f"memory, {vec}-element vectors)")
    if k_pages.data_ptr() % 16 or (not latent and v_pages.data_ptr() % 16):
        raise ValueError("paged_attention_cuda: pages must be 16-byte "
                         "aligned (vector loads)")
    out = torch.empty((b, khn, tr, dv), dtype=torch.float32,
                      device=q.device)
    ws = workspace_floats(b, khn, tr, d, n_split)
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
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {rc}")
    if latent:
        paged_attention_cuda.latent_launches += 1
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
