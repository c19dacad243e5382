"""GQSA sparse-quantized GEMV: the wrapper of the hand-written CUDA kernel
(``repro_torch/csrc/gqsa_gemv.cu``). Its plain PyTorch version is
``kernels/ref.py:gqsa_gemv_ref``.

Replaces the TPU kernel ``src/repro/kernels/gqsa_gemv.py:gqsa_gemv_pallas``
(body ``_kernel``), which every compressed projection of the model reaches
in prefill and decode, and the same kernel under the reference's
``vmap`` over the stacked routed experts of an MoE layer
(``src/repro/models/moe.py:_expert_ffn``): :func:`gqsa_gemv_experts_cuda`,
one launch per projection and chunk of buffer rows, with an expert grid
axis.

Bound on the H100: bytes. The kernel streams each kept group's 20-byte
payload (8 code bytes, int32 idx, f32 scale and zero) once; the floor is
N * M * 20 bytes over 3.35 TB/s (wq of llama2-7b: 10.5 MB -> 3.1 us;
wg/wu/wd: 28.2 MB -> 8.4 us).

Design: one warp per output row, lanes splitting the row's groups with
coalesced 64-bit code loads, nibbles dequantised in registers and reused
for every activation row, activations read through the cache, a shuffle
reduction per row (details in the CUDA source). The wrapper pads nothing;
it takes at most ``MAX_GEMV_BATCH`` rows per launch, and the dispatcher
(``kernels/ops.py``) chunks larger batches. On the expert axis an
optional ``rows`` [E] operand skips each expert's empty buffer rows, and
an expert with none is never read: at 4-slot DeepSeek-V2 decode at most
24 of 160 experts hold a row, so at most 24 x 14.7 MB of a layer's
2.36 GB of expert payload is streamed (bound: those bytes over 3.35 TB/s).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.bsr import BSRMatrix
from repro_torch.kernels.build import load

MAX_GEMV_BATCH = 8
GROUP_SIZE = 16     # the kernel's group size (8 code bytes per group)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("gqsa_gemv").gqsa_gemv_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _experts_launcher():
    fn = load("gqsa_gemv").gqsa_gemv_experts_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    """y [B, N] f32 = x [B, K] @ dense(bsr).T on the card, 1 <= B <= 8.

    x: f32 or bf16, contiguous; bsr: one layer's padded form (2-D leaves)
    with group size 16, on x's device."""
    b = x.shape[0]
    if x.dim() != 2 or not 1 <= b <= MAX_GEMV_BATCH:
        raise ValueError(f"gqsa_gemv_cuda takes x [B, K] with "
                         f"1..{MAX_GEMV_BATCH} rows, got {tuple(x.shape)}")
    _check_operands(x, bsr, (b,))
    k = x.shape[1]
    n, m = bsr.idx.shape
    y = torch.empty((b, n), dtype=torch.float32, device=x.device)
    rc = _launcher()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                     bsr.idx.data_ptr(), bsr.vals.data_ptr(),
                     bsr.scale.data_ptr(), bsr.zero.data_ptr(), y.data_ptr(),
                     b, n, m, k, torch.cuda.current_stream(x.device).cuda_stream)
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
