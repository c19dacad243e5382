"""GQSA sparse-quantized GEMV: the wrapper of the hand-written CUDA kernel
(``repro_torch/csrc/gqsa_gemv.cu``). Its plain PyTorch version is
``kernels/ref.py:gqsa_gemv_ref``; ``ref.py:gqsa_gemv_grouped_ref`` repeats
the kernel's order of arithmetic.

Replaces the TPU kernel ``src/repro/kernels/gqsa_gemv.py:gqsa_gemv_pallas``
(body ``_kernel``), which every compressed projection of the model reaches
in prefill and decode, and the same kernel under the reference's
``vmap`` over the stacked routed experts of an MoE layer
(``src/repro/models/moe.py:_expert_ffn``): :func:`gqsa_gemv_experts_cuda`,
one launch per projection and chunk of buffer rows, with an expert grid
axis.

Bound on the H100: bytes. The kernel streams each kept group's 20-byte
payload (8 code bytes, int32 idx, f32 scale and zero) once; the floor is
N * M * 20 bytes, plus x and y, over 3.35 TB/s (wq of llama2-7b: 10.5 MB
-> 3.1 us; wg/wu/wd: 28.2 MB -> 8.4 us; a layer: 38.0 us at T = 4, 46.1
us at T = 116). The products (16 multiply-adds a kept group and row, bf16
x by exact 4-bit codes) take the tensor cores' 989 TFLOP/s, under the
bytes up to T of about 280. The kernel runs them on CUDA cores in f32
and is bound by that arithmetic at every T (~41 instructions a kept
group and row, 16 of them the bf16 widening of x), far above the byte
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

The expert axis keeps the first design: one warp per output row, lanes
splitting the row's groups, activations read through the cache, at most
``MAX_GEMV_BATCH`` rows a launch. An optional ``rows`` [E] operand skips
each expert's empty buffer rows, and an expert with none is never read:
at 4-slot DeepSeek-V2 decode at most 24 of 160 experts hold a row, so at
most 24 x 14.7 MB of a layer's 2.36 GB of expert payload is streamed
(bound: those bytes over 3.35 TB/s).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.bsr import BSRMatrix
from repro_torch.kernels.build import load, sm_count

MAX_GEMV_BATCH = 8  # x rows a launch of the expert axis
GROUP_SIZE = 16     # the kernel's group size (8 code bytes per group)
STREAM_WARPS = 16   # warps a block of the streaming kernel
# The block's shared-memory layout, as the CUDA source lays it out (its
# launcher refuses a size that differs from its own count):
STAGE_BYTES = 640   # a warp's ring stage: 32 slots x 20 bytes (`Stage`)
RING_DEPTH = 3      # stages of a warp's ring (`kDepth`)
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on sm_90
TILES = {2: (1, 2, 4, 8), 4: (1, 2, 4)}   # token tiles, by x's item size


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("gqsa_gemv").gqsa_gemv_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 7 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _experts_launcher():
    fn = load("gqsa_gemv").gqsa_gemv_experts_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(tt: int, k: int, itemsize: int) -> int:
    """Dynamic shared memory of a block: the x tile ([K/16][tt][16] of
    x's type), its group sums ([K/16][tt] f32, rounded up to 16 bytes)
    and ``STREAM_WARPS`` rings of ``RING_DEPTH`` stages."""
    groups = k // GROUP_SIZE
    return (groups * tt * 16 * itemsize + -(-groups * tt * 4 // 16) * 16
            + STREAM_WARPS * RING_DEPTH * STAGE_BYTES)


def token_tile(t: int, k: int, itemsize: int) -> int:
    """x rows a block takes: the smallest of ``TILES[itemsize]`` that
    holds all ``t`` rows, else the largest, among those whose x fits a
    block (a larger tile converts each kept group's codes once for more
    rows; a tile past T computes on zero rows)."""
    fits = [tt for tt in TILES[itemsize]
            if smem_bytes(tt, k, itemsize) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"gqsa_gemv_cuda: K={k} does not fit a block's "
                         f"shared memory")
    return next((tt for tt in fits if tt >= t), fits[-1])


class Plan(NamedTuple):
    tile: int      # x rows a block (token tile)
    tiles: int     # token tiles, ceil(T / tile)
    blocks: int    # grid: tiles x blocks a tile


def plan(t: int, n: int, k: int, itemsize: int, sms: int) -> Plan:
    """The launch of T = ``t`` rows against an [N, K] matrix from shapes
    and the SM count alone: one block an SM (a block of 16 warps holds
    the SM's shared memory), as many on every tile, at least one, and no
    block without a row (N / 16 blocks a tile at most)."""
    tt = token_tile(t, k, itemsize)
    tiles = -(-t // tt)
    per_tile = max(1, min(sms // tiles, -(-n // STREAM_WARPS)))
    return Plan(tt, tiles, tiles * per_tile)


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
    if x.device.type != "cuda":
        raise ValueError("gqsa_gemv_cuda: x must be a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gqsa_gemv_cuda: x must be f32 or bf16, "
                        f"got {x.dtype}")
    if bsr.group_size != GROUP_SIZE or bsr.bits > 4:
        raise NotImplementedError(
            f"gqsa_gemv_cuda takes group size {GROUP_SIZE} with <= 4-bit "
            f"codes, got G{bsr.group_size} W{bsr.bits}")
    k = x.shape[-1]
    n, m = bsr.idx.shape[-2:]
    if (n, k) != tuple(bsr.shape):
        raise ValueError(f"gqsa_gemv_cuda: x has K={k}, bsr is {bsr.shape}")
    w = tuple(lead[:-1])
    _check(x, "x", x.dtype, tuple(lead) + (k,))
    _check(bsr.idx, "idx", torch.int32, w + (n, m))
    _check(bsr.vals, "vals", torch.uint8, w + (n, m, GROUP_SIZE // 2))
    _check(bsr.scale, "scale", torch.float32, w + (n, m))
    _check(bsr.zero, "zero", torch.float32, w + (n, m))
    if x.data_ptr() % 16 or bsr.vals.data_ptr() % 8:
        raise ValueError("gqsa_gemv_cuda: x must be 16-byte and vals "
                         "8-byte aligned (vector loads)")


def gqsa_gemv_cuda(x: torch.Tensor, bsr: BSRMatrix) -> torch.Tensor:
    """y [T, N] f32 = x [T, K] @ dense(bsr).T on the card, any T >= 1, in
    one launch (``launches`` counts them).

    x: f32 or bf16, contiguous; bsr: one layer's padded form (2-D leaves)
    with group size 16, on x's device."""
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"gqsa_gemv_cuda takes x [T, K] with T >= 1, got "
                         f"{tuple(x.shape)}")
    t, k = x.shape
    _check_operands(x, bsr, (t,))
    n, m = bsr.idx.shape
    p = plan(t, n, k, x.element_size(), sm_count(x.device.index))
    y = torch.empty((t, n), dtype=torch.float32, device=x.device)
    rc = _launcher()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                     bsr.idx.data_ptr(), bsr.vals.data_ptr(),
                     bsr.scale.data_ptr(), bsr.zero.data_ptr(), y.data_ptr(),
                     t, n, m, k, p.tile, p.tiles, p.blocks,
                     smem_bytes(p.tile, k, x.element_size()),
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gqsa_gemv kernel launch failed: CUDA error {rc}")
    gqsa_gemv_cuda.launches += 1
    return y


gqsa_gemv_cuda.launches = 0


def gqsa_gemv_experts_cuda(x: torch.Tensor, bsr: BSRMatrix,
                           rows: Optional[torch.Tensor] = None,
                           y: Optional[torch.Tensor] = None,
                           c0: int = 0, width: Optional[int] = None
                           ) -> torch.Tensor:
    """y [E, C, N] f32 with y[e] = x[e] @ dense(expert e of bsr).T, for
    buffer rows ``c0 .. c0 + width - 1`` (at most 8, all C by default) of
    every expert, in one launch (``launches`` counts them).

    x: [E, C, K] f32 or bf16, contiguous; bsr: stacked padded form
    ([E, N, M] leaves, group size 16); ``rows`` [E] int32: rows at or past
    ``rows[e]`` are written as zeros and an expert with no row is not
    read; ``y``: the output to fill (allocated when None)."""
    if x.dim() != 3:
        raise ValueError(f"gqsa_gemv_experts_cuda takes x [E, C, K], got "
                         f"{tuple(x.shape)}")
    e, c, k = x.shape
    width = c - c0 if width is None else width
    if not (1 <= width <= MAX_GEMV_BATCH and 0 <= c0 and c0 + width <= c):
        raise ValueError(f"gqsa_gemv_experts_cuda takes 1..{MAX_GEMV_BATCH}"
                         f" rows a launch, got rows {c0}..{c0 + width - 1} "
                         f"of {c}")
    _check_operands(x, bsr, (e, c))
    n, m = bsr.idx.shape[-2:]
    if rows is not None:
        _check(rows, "rows", torch.int32, (e,))
    if y is None:
        y = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    _check(y, "y", torch.float32, (e, c, n))
    rc = _experts_launcher()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), bsr.idx.data_ptr(),
        bsr.vals.data_ptr(), bsr.scale.data_ptr(), bsr.zero.data_ptr(),
        y.data_ptr(), None if rows is None else rows.data_ptr(), e, c, c0,
        width, n, m, k, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gqsa_gemv experts kernel launch failed: CUDA "
                           f"error {rc}")
    gqsa_gemv_experts_cuda.launches += 1
    return y


gqsa_gemv_experts_cuda.launches = 0
