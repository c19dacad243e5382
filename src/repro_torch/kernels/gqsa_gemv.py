"""GQSA sparse-quantized GEMV: the wrapper of the hand-written CUDA kernel
(``repro_torch/csrc/gqsa_gemv.cu``). Its plain PyTorch version is
``kernels/ref.py:gqsa_gemv_ref``; ``ref.py:gqsa_gemv_grouped_ref`` repeats
the kernel's order of arithmetic.

Replaces the TPU kernel ``src/repro/kernels/gqsa_gemv.py:gqsa_gemv_pallas``
(body ``_kernel``), which every compressed projection of the model reaches
in prefill and decode, and the same kernel under the reference's
``vmap`` over the stacked routed experts of an MoE layer
(``src/repro/models/moe.py:_expert_ffn``): :func:`gqsa_gemv_experts_cuda`,
one launch per projection at any capacity.

Group sizes: 8, 16, 32, 64 and 128 (``GROUP_SIZES``), each its own
instantiation of the kernels, picked from ``bsr.group_size``; any other
raises (the reference takes any even g: ROADMAP.md B.8). Above 32 a kept
group is g / 32 work items, its 32-code parts, each computed as a g = 32
group against x staged in 32-column lines (``line_values``).

Bound on the H100: bytes. The kernel streams each kept group's payload
(g/2 code bytes, int32 idx, f32 scale and zero: ``payload_bytes``, 16,
20, 28, 44 and 76 bytes at g = 8, 16, 32, 64, 128) once; the floor is N *
M times that, plus x and y, over 3.35 TB/s (at g = 16: wq of llama2-7b
10.5 MB -> 3.1 us; wg/wu/wd 28.2 MB -> 8.4 us; a layer 38.0 us at T = 4,
46.1 us at T = 116; at T = 4 21.1 us at g = 64, 18.2 us at g = 128). The
products (g multiply-adds a kept group and row, bf16 x by exact 4-bit
codes) take the tensor cores' 989 TFLOP/s, under the bytes
up to T of about 280. The kernel runs them on CUDA cores in f32 and is
bound by that arithmetic at every T (~41 instructions a kept group and
row at g = 16, 16 of them the bf16 widening of x), far above the byte
floor (PERF.md).

Design of :func:`gqsa_gemv_cuda` (details in the CUDA source): one
launch at any T. One block of ``STREAM_WARPS`` warps per SM stages its
token tile of x (``token_tile`` rows) and the tile's group sums in shared
memory once; a warp owns whole output rows, each lane copies its slots'
payload with ``cp.async`` into the warp's ring, ``RING_DEPTH - 1``
stages ahead; the zero folds out (s * sum q x - s z * sum x, on the raw codes)
and a row's sums are added in a fixed order, so repeats are
bit-identical. ``plan`` picks the tile and the grid from shapes and the
SM count alone; nothing is read on the host, and nothing is padded or
copied.

The expert axis runs the same design in one launch at any capacity C:
token tiles of ``token_tile(C)`` buffer rows, rings ``EXPERT_RING_DEPTH``
deep, two rows a warp where a row's work items leave half a warp's last
trip idle (``row_lanes``), and a grid of one block an SM (``experts_plan``,
from shapes and the SM count). Each block counts the occupied (expert, tile) pairs from
``rows`` [E] on the card and walks its equal share of their output rows;
buffer rows at or past ``rows[e]`` come out as zeros from the same launch,
and an idle expert is never read: at 4-slot DeepSeek-V2 decode at most 24
of 160 experts hold a row, so at most 24 x 14.7 MB of a layer's 2.36 GB
of expert payload is streamed (bound: those bytes over 3.35 TB/s).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.bsr import BSRMatrix
from repro_torch.kernels.build import load, sm_count

GROUP_SIZES = (8, 16, 32, 64, 128)   # the kernels' group sizes
STREAM_WARPS = 16   # warps a block of the streaming kernel
# The block's shared-memory layout, as the CUDA source lays it out (its
# launcher refuses a size that differs from its own count):
# a warp's ring stage by group size: 32 work items x (codes + 12) bytes,
# an item's codes g/2 bytes up to g = 32 and a 16-byte part above
# (`Stage<G>`)
STAGE_BYTES = {8: 512, 16: 640, 32: 896, 64: 896, 128: 896}
RING_DEPTH = 3      # stages of a warp's ring (`kDepth`)
EXPERT_RING_DEPTH = 4   # the same on the expert axis (`kExpertDepth`)
CTRL_BYTES = 128    # the expert axis's block-shared ints (`kCtrlInts`)
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on sm_90
TILES = {2: (1, 2, 4, 8), 4: (1, 2, 4)}   # token tiles, by x's item size


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("gqsa_gemv").gqsa_gemv_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 8 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _experts_launcher():
    fn = load("gqsa_gemv").gqsa_gemv_experts_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 9 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def payload_bytes(g: int) -> int:
    """Bytes a kept group streams at group size ``g``: g/2 code bytes,
    int32 idx, f32 scale and zero."""
    return g // 2 + 12


def line_values(g: int) -> int:
    """x values a staged line holds at group size ``g``, and codes a work
    item converts: g up to 32; 32 above, where a kept group is g / 32 work
    items (its parts) and x is staged as at g = 32 (`Width<G>::kLine`)."""
    return min(g, 32)


def smem_bytes(tt: int, k: int, g: int, itemsize: int) -> int:
    """Dynamic shared memory of a block at group size ``g``: the x tile
    ([K/l][tt][l] of x's type, l = ``line_values(g)``), its line sums
    ([K/l][tt] f32, rounded up to 16 bytes) and ``STREAM_WARPS`` rings of
    ``RING_DEPTH`` stages of ``STAGE_BYTES[g]``."""
    lines = k // line_values(g)
    return (k * tt * itemsize + -(-lines * tt * 4 // 16) * 16
            + STREAM_WARPS * RING_DEPTH * STAGE_BYTES[g])


def experts_smem_bytes(tt: int, k: int, g: int, itemsize: int) -> int:
    """The expert axis's block: :func:`smem_bytes` with rings of
    ``EXPERT_RING_DEPTH`` stages, then ``CTRL_BYTES`` of block-shared
    ints (warp totals of the pair count, the segment's expert and tile)."""
    return (smem_bytes(tt, k, g, itemsize)
            + STREAM_WARPS * (EXPERT_RING_DEPTH - RING_DEPTH)
            * STAGE_BYTES[g] + CTRL_BYTES)


def token_tile(t: int, k: int, g: int, itemsize: int,
               size=smem_bytes) -> int:
    """x rows a block takes: the smallest of ``TILES[itemsize]`` that
    holds all ``t`` rows, else the largest, among those whose x fits a
    block (``size``: the block's shared memory at a tile; a larger tile
    converts each kept group's codes once for more rows; a tile past T
    computes on zero rows). llama2-7b's wd (K = 11008) at 8 bf16 rows
    fits at g = 16 and above but not at g = 8 (its group sums take 44032
    bytes), so there it takes 4; g = 64 and 128 take g = 32's count."""
    fits = [tt for tt in TILES[itemsize]
            if size(tt, k, g, itemsize) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"gqsa_gemv_cuda: K={k} does not fit a block's "
                         f"shared memory")
    return next((tt for tt in fits if tt >= t), fits[-1])


class Plan(NamedTuple):
    tile: int      # x rows a block (token tile)
    tiles: int     # token tiles, ceil(T / tile)
    blocks: int    # grid: tiles x blocks a tile


def plan(t: int, n: int, k: int, g: int, itemsize: int, sms: int) -> Plan:
    """The launch of T = ``t`` rows against an [N, K] matrix of group size
    ``g`` from shapes and the SM count alone: one block an SM (a block of
    16 warps holds the SM's shared memory), as many on every tile, at
    least one, and no block without a row (N / 16 blocks a tile at
    most)."""
    tt = token_tile(t, k, g, itemsize)
    tiles = -(-t // tt)
    per_tile = max(1, min(sms // tiles, -(-n // STREAM_WARPS)))
    return Plan(tt, tiles, tiles * per_tile)


class ExpertsPlan(NamedTuple):
    tile: int       # buffer rows a token tile
    row_lanes: int  # lanes a row: 32, or 16 (two rows a warp)
    blocks: int     # grid
    smem: int       # dynamic shared memory a block


def row_lanes(items: int) -> int:
    """Lanes a row for a row's work items (its M kept groups at g <= 32,
    M * g / 32 parts above): 16 (two rows a warp) when a row's last
    32-item trip would be half empty or less (M = 48 and 44, the w_d of
    both MoE families at g = 16: 25% and 31% of a row's lane-slots idle
    against 0% and 8%), else 32."""
    return 16 if 0 < items % 32 <= 16 else 32


def experts_plan(e: int, c: int, n: int, m: int, k: int, g: int,
                 itemsize: int, sms: int) -> ExpertsPlan:
    """The expert axis's launch for E = ``e`` experts of C = ``c`` buffer
    rows against [N, K] matrices of M = ``m`` kept groups a row at group
    size ``g``, from shapes and the SM count alone: the token tile as
    :func:`token_tile`
    takes it for C rows, :func:`row_lanes` of a row's M * g / l work
    items (l = :func:`line_values`), and one block an SM, fewer
    only when every expert holding all C rows gives fewer than 16 rows (a
    block's warps) a block. The kernel shares the occupied pairs' rows out
    over whatever grid it gets."""
    tt = token_tile(c, k, g, itemsize, experts_smem_bytes)
    rows_all = e * -(-c // tt) * n
    blocks = max(1, min(sms, -(-rows_all // STREAM_WARPS)))
    return ExpertsPlan(tt, row_lanes(m * g // line_values(g)), blocks,
                       experts_smem_bytes(tt, k, g, itemsize))


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"gqsa_gemv: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"gqsa_gemv: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"gqsa_gemv: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"gqsa_gemv: {name} must be contiguous")


def _check_operands(x: torch.Tensor, bsr: BSRMatrix, lead) -> None:
    """x [*lead, B, K] against a padded BSR whose leaves carry the
    leading dims ``lead[:-1]`` (one matrix: none; the expert axis: E)."""
    if bsr.group_size not in GROUP_SIZES or bsr.bits > 4:
        raise NotImplementedError(
            f"gqsa_gemv_cuda takes group sizes {GROUP_SIZES} with <= 4-bit "
            f"codes, got G{bsr.group_size} W{bsr.bits} (other group sizes: "
            f"ROADMAP.md B.8)")
    if x.device.type != "cuda":
        raise ValueError("gqsa_gemv_cuda: x must be a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gqsa_gemv_cuda: x must be f32 or bf16, "
                        f"got {x.dtype}")
    g = bsr.group_size
    k = x.shape[-1]
    n, m = bsr.idx.shape[-2:]
    if (n, k) != tuple(bsr.shape):
        raise ValueError(f"gqsa_gemv_cuda: x has K={k}, bsr is {bsr.shape}")
    w = tuple(lead[:-1])
    _check(x, "x", x.dtype, tuple(lead) + (k,))
    _check(bsr.idx, "idx", torch.int32, w + (n, m))
    _check(bsr.vals, "vals", torch.uint8, w + (n, m, g // 2))
    _check(bsr.scale, "scale", torch.float32, w + (n, m))
    _check(bsr.zero, "zero", torch.float32, w + (n, m))
    # a work item's codes are one copy of g/2 bytes, 16 above g = 32
    align = line_values(g) // 2
    if x.data_ptr() % 16 or bsr.vals.data_ptr() % align:
        raise ValueError(f"gqsa_gemv_cuda: x must be 16-byte and vals "
                         f"{align}-byte aligned (vector loads)")


def gqsa_gemv_cuda(x: torch.Tensor, bsr: BSRMatrix) -> torch.Tensor:
    """y [T, N] f32 = x [T, K] @ dense(bsr).T on the card, any T >= 1, in
    one launch (``launches`` counts them).

    x: f32 or bf16, contiguous; bsr: one layer's padded form (2-D leaves)
    with a group size of ``GROUP_SIZES``, on x's device."""
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"gqsa_gemv_cuda takes x [T, K] with T >= 1, got "
                         f"{tuple(x.shape)}")
    t, k = x.shape
    _check_operands(x, bsr, (t,))
    n, m = bsr.idx.shape
    g = bsr.group_size
    p = plan(t, n, k, g, x.element_size(), sm_count(x.device.index))
    y = torch.empty((t, n), dtype=torch.float32, device=x.device)
    rc = _launcher()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                     bsr.idx.data_ptr(), bsr.vals.data_ptr(),
                     bsr.scale.data_ptr(), bsr.zero.data_ptr(), y.data_ptr(),
                     t, n, m, k, g, p.tile, p.tiles, p.blocks,
                     smem_bytes(p.tile, k, g, x.element_size()),
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gqsa_gemv kernel launch failed: CUDA error {rc}")
    gqsa_gemv_cuda.launches += 1
    return y


gqsa_gemv_cuda.launches = 0


def gqsa_gemv_experts_cuda(x: torch.Tensor, bsr: BSRMatrix,
                           rows: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """y [E, C, N] f32 with y[e] = x[e] @ dense(expert e of bsr).T, any
    C >= 1, in one launch (``launches`` counts them).

    x: [E, C, K] f32 or bf16, contiguous; bsr: stacked padded form
    ([E, N, M] leaves, a group size of ``GROUP_SIZES``); ``rows`` [E]
    int32 or None (every
    row holds a token): rows at or past ``rows[e]`` are written as zeros
    and an expert with no row is not read."""
    if x.dim() != 3 or x.shape[1] < 1:
        raise ValueError(f"gqsa_gemv_experts_cuda takes x [E, C, K] with "
                         f"C >= 1, got {tuple(x.shape)}")
    e, c, k = x.shape
    _check_operands(x, bsr, (e, c))
    n, m = bsr.idx.shape[-2:]
    if rows is not None:
        _check(rows, "rows", torch.int32, (e,))
    g = bsr.group_size
    p = experts_plan(e, c, n, m, k, g, x.element_size(),
                     sm_count(x.device.index))
    y = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    rc = _experts_launcher()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), bsr.idx.data_ptr(),
        bsr.vals.data_ptr(), bsr.scale.data_ptr(), bsr.zero.data_ptr(),
        y.data_ptr(), None if rows is None else rows.data_ptr(), e, c, n, m,
        k, g, p.tile, p.row_lanes, p.blocks, p.smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gqsa_gemv experts kernel launch failed: CUDA "
                           f"error {rc}")
    gqsa_gemv_experts_cuda.launches += 1
    return y


gqsa_gemv_experts_cuda.launches = 0
