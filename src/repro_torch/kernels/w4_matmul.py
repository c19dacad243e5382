"""Dense grouped-dequant W4 matmul: the wrapper of the hand-written CUDA
kernel (``repro_torch/csrc/w4_matmul.cu``). Its plain PyTorch version is
``kernels/ref.py:w4_matmul_ref``.

Replaces the TPU kernel ``src/repro/kernels/w4_matmul.py:w4_matmul_pallas``
(body ``_kernel``), which every projection of the dense-W4 baseline
(``--compress w4``, the paper's W4A16 rows) reaches in prefill and decode.

Bound on the H100: bytes. At decode each code byte and each f32
scale/zero is used for a few multiply-adds; the floor is
(N*K/2 + 8*N*K/G + x + y) bytes over 3.35 TB/s (wq of llama2-7b at G16:
16.9 MB -> 5.0 us; wg/wu/wd: 45.1 MB -> 13.5 us).

Design: a block owns 32 output rows and a tile of at most 8 rows of x,
stages x in shared memory one K chunk at a time, and dequantises each
lane's codes in registers (16-byte loads issued a chunk ahead) for f32
dot products (details in the CUDA source). The kernel masks the ragged
edges of T, N and K itself: the wrapper pads and copies nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load

VEC_K = 64      # K multiple (and 16-byte qw alignment) of the vector path


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("w4_matmul").w4_matmul_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"w4_matmul: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"w4_matmul: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"w4_matmul: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"w4_matmul: {name} must be contiguous")


def w4_matmul_cuda(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor, group_size: int) -> torch.Tensor:
    """y [T, N] f32 = x [T, K] @ deq(qw).T on the card, any T >= 1.

    x: f32 or bf16; qw: uint8 [N, K/2]; scale/zero: f32 [N, K/G]; all
    contiguous on one card. G must be even and divide K."""
    if x.device.type != "cuda":
        raise ValueError("w4_matmul_cuda: x must be a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w4_matmul_cuda: x must be f32 or bf16, "
                        f"got {x.dtype}")
    t, k = x.shape
    n = qw.shape[0]
    g = group_size
    if t < 1 or g < 2 or g % 2 or k % g:
        raise ValueError(f"w4_matmul_cuda takes T >= 1 rows and an even "
                         f"group size dividing K, got T={t}, K={k}, G={g}")
    _check(x, "x", x.dtype, (t, k))
    _check(qw, "qw", torch.uint8, (n, k // 2))
    _check(scale, "scale", torch.float32, (n, k // g))
    _check(zero, "zero", torch.float32, (n, k // g))
    if len({x.device, qw.device, scale.device, zero.device}) != 1:
        raise ValueError("w4_matmul_cuda: operands lie on different cards")
    vec = k % VEC_K == 0 and qw.data_ptr() % 16 == 0
    y = torch.empty((t, n), dtype=torch.float32, device=x.device)
    rc = _launcher()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                     qw.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                     y.data_ptr(), t, n, k, g, int(vec),
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w4_matmul kernel launch failed: CUDA error {rc}")
    w4_matmul_cuda.launches += 1
    return y


w4_matmul_cuda.launches = 0
